"""Training-data artifacts and curation (a copy of the JAX package's
``data.py``: the same files, the same curation, the same cache).

File contract (kept byte-compatible with the reference so runs resume across
implementations): per-iteration directory ``iter_i/`` holding
``train_samples_x.txt`` / ``train_samples_y.npy`` / ``val_samples_x.txt`` /
``val_samples_y.npy`` (+ ``best_samples_*`` when optimizer-centred points are
enabled).  Reference: linna/util.py:1167-1258 (writers),
linna/util.py:1342-1438 (reader + outlier curation).

Curation mirrors linna/util.py:1410-1438: clip runaway theory outputs to
sentinel values, and in ``ypositive`` mode drop rows whose theory evaluation
failed entirely (all-1e-30).
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "TrainingData",
    "sample_x_path",
    "sample_y_path",
    "save_samples_x",
    "save_samples_y",
    "load_iteration_stack",
    "curate",
    "load_curated_stack",
    "clear_cache",
]


def sample_x_path(outdir: str, name: str) -> str:
    """Parameter-sample filename for a split.  The reference names the
    best-point validation split ``best_samples_x_val.txt`` — suffix, not
    prefix (linna/util.py:1243-1252) — kept for byte-compatible resume."""
    if name == "best_val":
        return os.path.join(outdir, "best_samples_x_val.txt")
    return os.path.join(outdir, f"{name}_samples_x.txt")


def sample_y_path(outdir: str, name: str) -> str:
    """Theory-output filename for a split (see :func:`sample_x_path`)."""
    if name == "best_val":
        return os.path.join(outdir, "best_samples_y_val.npy")
    return os.path.join(outdir, f"{name}_samples_y.npy")


@dataclass
class TrainingData:
    """Curated training/validation arrays plus the subset used to fit the
    Y-standardization (the reference's ``train_y_last``: the *first*
    iteration's training outputs, linna/util.py:1365-1367,1449)."""

    train_x: np.ndarray
    train_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    train_y_for_stats: np.ndarray


def save_samples_x(outdir: str, name: str, x: np.ndarray) -> None:
    np.savetxt(os.path.join(outdir, f"{name}_samples_x.txt"), x)


def save_samples_y(outdir: str, name: str, y: np.ndarray) -> None:
    np.save(os.path.join(outdir, f"{name}_samples_y.npy"), y)


def _load_pairs(
    outdir_list: Sequence[str], name: str, skip_missing: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a split across iteration directories.

    ``ndmin=2`` keeps one-parameter (single-column) and single-row files 2-D
    — the reference's ``len(_) > 1`` skip (linna/util.py:1347-1357) existed
    to work around np.loadtxt's squeeze and silently dropped both cases.
    ``skip_missing`` tolerates directories without the split's files (an
    iteration that ran with best points disabled) AND an all-empty split —
    returning ``(None, None)`` in that case: ``chisqcut`` can legitimately
    empty the best files when the optimizer's MAP estimate lands far from
    the data (the reference tolerates this via its ``len(_) > 1`` guards,
    linna/util.py:1342-1373; found by the all-options flagship run).
    """
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    for outdir in outdir_list:
        xpath = sample_x_path(outdir, name)
        ypath = sample_y_path(outdir, name)
        if skip_missing and not (os.path.isfile(xpath) and os.path.isfile(ypath)):
            continue
        x = np.loadtxt(xpath, ndmin=2)
        if x.size:
            xs.append(x)
        y = np.atleast_2d(np.load(ypath))
        if y.size:
            ys.append(y)
    if not xs or not ys:
        if skip_missing:
            return None, None
        raise ValueError(
            f"no '{name}' sample rows found under {list(outdir_list)}"
        )
    x_all, y_all = np.concatenate(xs), np.concatenate(ys)
    if len(x_all) != len(y_all):
        raise ValueError(
            f"misaligned '{name}' artifacts: {len(x_all)} x rows vs "
            f"{len(y_all)} y rows across {list(outdir_list)}"
        )
    return x_all, y_all


def load_iteration_stack(
    outdir_list: Sequence[str], usebest: bool = False
) -> TrainingData:
    """Concatenate all iterations' train/val sets (reference
    linna/util.py:1342-1408); optionally prepend optimizer-centred ``best``
    points.  Iterations that ran with best points disabled (per-iteration
    ``nbest``) simply contribute none — the reference crashed on the missing
    files."""
    train_x, train_y = _load_pairs(outdir_list, "train")
    val_x, val_y = _load_pairs(outdir_list, "val")
    y_stats = np.load(os.path.join(outdir_list[0], "train_samples_y.npy"))
    if len(y_stats) == 0:
        y_stats = train_y
    if usebest:
        bx, by = _load_pairs(outdir_list, "best", skip_missing=True)
        if bx is not None:
            train_x = np.concatenate([bx, train_x])
            train_y = np.concatenate([by, train_y])
        bvx, bvy = _load_pairs(outdir_list, "best_val", skip_missing=True)
        if bvx is None:
            # pre-best_val artifact layout: validate on the best points
            bvx, bvy = bx, by
        if bvx is not None:
            val_x = np.concatenate([bvx, val_x])
            val_y = np.concatenate([bvy, val_y])
    return TrainingData(train_x, train_y, val_x, val_y, y_stats)


def curate(data: TrainingData, ypositive: bool = False) -> TrainingData:
    """Outlier clipping + failed-row removal (reference linna/util.py:1410-1438).

    ypositive: clip to [1e-30, 1e10]; rows whose mean equals 1e-30 (theory
    failure sentinel) are removed, and sentinel entries in the stats set are
    replaced by the per-column training median.
    default: train clipped to [-1e5, 1e10], val to [-1e5, 1e8].
    """
    train_x = np.array(data.train_x, dtype=np.float64)
    train_y = np.array(data.train_y, dtype=np.float64)
    val_x = np.array(data.val_x, dtype=np.float64)
    val_y = np.array(data.val_y, dtype=np.float64)
    y_stats = np.array(data.train_y_for_stats, dtype=np.float64)

    if ypositive:
        train_y = np.clip(train_y, 1e-30, 1e10)
        val_y = np.clip(val_y, 1e-30, 1e10)
        y_stats = np.clip(y_stats, 1e-30, None)
        good = np.mean(train_y, axis=1) != 1e-30
        train_x, train_y = train_x[good], train_y[good]
        goodv = np.mean(val_y, axis=1) != 1e-30
        val_x, val_y = val_x[goodv], val_y[goodv]
        good_s = np.mean(y_stats, axis=1) != 1e-30
        y_stats = y_stats[good_s]
        # surviving sentinel entries -> per-column median of the full train set
        # (linna/util.py:1446)
        col_median = np.median(train_y, axis=0)
        rows, cols = np.where(y_stats == 1e-30)
        y_stats[rows, cols] = col_median[cols]
    else:
        train_y = np.clip(train_y, -1e5, 1e10)
        val_y = np.clip(val_y, -1e5, 1e8)
        y_stats = np.clip(y_stats, -1e5, 1e10)
    return TrainingData(train_x, train_y, val_x, val_y, y_stats)


# ------------------------------------------------------------- cached loader

# Per-directory cache of curated split arrays, keyed by the sample files'
# (size, mtime_ns, head/tail CRC).  The orchestrator re-stacks ALL previous iterations'
# data every iteration (reference linna/util.py:1342-1373) although those
# files are immutable once written — measured at the LSST flagship shape
# the redundant reload + f64 clip copies cost 145 s of the 587 s training
# wall (trace.json stack_fit_s).  Default-mode curation is a fixed
# per-element clip, so per-directory curated arrays are reusable verbatim;
# the ypositive sentinel-median replacement couples rows to the FULL stack
# and is recomputed on the stacked result (cheap).  Cached train/val arrays
# are float32 (what the trainer feeds the device anyway); the f64 stats set
# keeps the reference's transform-fit precision.  Entries are read-only
# views (writes raise) so a caller can't corrupt a future iteration's stack.
_DIR_CACHE: dict = {}


def clear_cache() -> None:
    """Drop all cached per-directory arrays.  Called at pipeline start so a
    long-lived process running many pipelines doesn't accumulate every
    outdir's arrays forever, and so reruns never see a previous run's data."""
    _DIR_CACHE.clear()


def _file_key(path: str):
    # (size, mtime_ns) alone can collide after a same-size in-place rewrite
    # within the filesystem's mtime granularity (network filesystems can be
    # 1 s) — _chisqcut_files and crash-resume flows do rewrite these files.
    # A CRC of the first + middle + last 4 KiB catches any realistic rewrite
    # for ~µs of IO, without hashing the multi-hundred-MB body.  (The middle
    # window closes the residual same-size rewrite that changes only interior
    # bytes outside head/tail — e.g. one edited row of a large .npy.)
    # The file is opened FIRST and fstat'd on the open handle so size, mtime
    # and CRC all describe the same inode even if the file is atomically
    # replaced between calls.
    with open(path, "rb") as fh:
        st = os.fstat(fh.fileno())
        head = fh.read(4096)
        crc = zlib.crc32(head)
        if st.st_size > 12288:
            fh.seek(st.st_size // 2)
            crc = zlib.crc32(fh.read(4096), crc)
        if st.st_size > 8192:
            fh.seek(-4096, os.SEEK_END)
        crc = zlib.crc32(fh.read(4096), crc)
    return (st.st_size, st.st_mtime_ns, crc)


def _load_curated_dir(outdir: str, ypositive: bool):
    """Curated (train_x, train_y, val_x, val_y, y_raw_f64) for ONE iteration
    directory, cached on the four sample files' identity."""
    files = [
        sample_x_path(outdir, "train"), sample_y_path(outdir, "train"),
        sample_x_path(outdir, "val"), sample_y_path(outdir, "val"),
    ]
    key = (ypositive,) + tuple(_file_key(f) for f in files)
    hit = _DIR_CACHE.get(outdir)
    if hit is not None and hit[0] == key:
        return hit[1]
    tx = np.loadtxt(files[0], ndmin=2)
    ty_raw = np.atleast_2d(np.load(files[1]))
    vx = np.loadtxt(files[2], ndmin=2)
    vy_raw = np.atleast_2d(np.load(files[3]))
    if len(tx) != len(ty_raw) or len(vx) != len(vy_raw):
        raise ValueError(
            f"misaligned sample artifacts under {outdir}: "
            f"{len(tx)}/{len(ty_raw)} train, {len(vx)}/{len(vy_raw)} val rows"
        )
    if ypositive:
        ty = np.clip(ty_raw, 1e-30, 1e10).astype(np.float32)
        vy = np.clip(vy_raw, 1e-30, 1e10).astype(np.float32)
        good = np.mean(ty, axis=1, dtype=np.float64) != np.float32(1e-30)
        tx, ty = tx[good], ty[good]
        goodv = np.mean(vy, axis=1, dtype=np.float64) != np.float32(1e-30)
        vx, vy = vx[goodv], vy[goodv]
    else:
        ty = np.clip(ty_raw, -1e5, 1e10).astype(np.float32)
        vy = np.clip(vy_raw, -1e5, 1e8).astype(np.float32)
    # x stays float64: it is tiny (ndim columns) and feeds the X-transform
    # fit, whose statistics keep the uncached path's f64 precision
    tx = np.asarray(tx, np.float64)
    vx = np.asarray(vx, np.float64)
    entry = (tx, ty, vx, vy, np.asarray(ty_raw, np.float64))
    for a in entry:
        a.setflags(write=False)
    _DIR_CACHE[outdir] = (key, entry)
    return entry


def load_curated_stack(
    outdir_list: Sequence[str], ypositive: bool = False, usebest: bool = False
) -> TrainingData:
    """Stacked + curated training data with per-directory caching — the
    orchestrator's fast path (same result as
    ``curate(load_iteration_stack(...))`` up to the y arrays' dtype:
    float32 here, which is what the trainer casts to regardless).

    The ``usebest`` optimizer-centred stacks go through the uncached
    reference path unchanged (they are small); the ypositive stats-set
    sentinel replacement runs on the stacked result exactly as
    :func:`curate` does.
    """
    if usebest:
        cur = curate(load_iteration_stack(outdir_list, usebest=True), ypositive)
        return TrainingData(
            cur.train_x,
            np.asarray(cur.train_y, np.float32),
            cur.val_x,
            np.asarray(cur.val_y, np.float32),
            cur.train_y_for_stats,
        )

    parts = [_load_curated_dir(d, ypositive) for d in outdir_list]
    # a chisqcut can empty an iteration's split entirely; its (0, 1)-shaped
    # arrays must be skipped (column counts differ), matching _load_pairs
    tparts = [p for p in parts if p[0].size]
    vparts = [p for p in parts if p[2].size]
    if not tparts or not vparts:
        name = "train" if not tparts else "val"
        raise ValueError(
            f"no '{name}' sample rows found under {list(outdir_list)}"
        )
    train_x = np.concatenate([p[0] for p in tparts])
    train_y = np.concatenate([p[1] for p in tparts])
    val_x = np.concatenate([p[2] for p in vparts])
    val_y = np.concatenate([p[3] for p in vparts])

    # stats set: first iteration's RAW training outputs, curated like curate();
    # empty-first-iteration fallback is the RAW stacked train set (f64, so the
    # 1e-30 sentinel comparisons below stay exact, as in load_iteration_stack)
    y_stats = parts[0][4]
    if len(y_stats) == 0:
        y_stats = np.concatenate([p[4] for p in parts if p[4].size])
    if ypositive:
        y_stats = np.clip(y_stats, 1e-30, None)
        good_s = np.mean(y_stats, axis=1) != 1e-30
        y_stats = y_stats[good_s]
        col_median = np.median(np.asarray(train_y, np.float64), axis=0)
        rows, cols = np.where(y_stats == 1e-30)
        y_stats = np.array(y_stats)
        y_stats[rows, cols] = col_median[cols]
    else:
        y_stats = np.clip(y_stats, -1e5, 1e10)
    return TrainingData(train_x, train_y, val_x, val_y, y_stats)
