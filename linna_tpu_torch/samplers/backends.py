"""Incremental chain stores with the JAX package's HDF5 layouts.

- Emcee layout: file ``chemcee_256.h5``, group ``mcmc`` holding ``chain``
  (it, W, D), ``chain_transformed``, ``log_prob`` (it, W), ``accepted`` (W,)
  and an ``iteration`` attribute.
- Zeus layout: file ``zeus_256.h5``, root datasets ``samples``,
  ``chain_transformed`` and ``logprob`` (gzip) plus a root ``iteration``
  attribute written last, which bounds every read past a torn append.

Both keep an exact-resume ``sampler_state`` group.  A file written by either
package reads in the other.

h5py is imported at first use.  Where it cannot be imported, the same
datasets, attributes and ``sampler_state`` group go into a directory beside
the requested name (``<filename>.d``): each growable dataset is a raw row file
that an append extends by one chunk, and the rest is a small ``index.npz``;
:func:`store_kind` says which store is in use.  Where h5py exists and
``<filename>`` does not, a directory store beside it is read and extended;
:func:`export_hdf5` writes one as an HDF5 file.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

__all__ = ["EmceeBackend", "ZeusBackend", "export_hdf5", "store_kind"]

STATE_GROUP = "sampler_state"


# ------------------------------------------------------------ directory store

_INDEX = "index.npz"


class _SmallDataset:
    """The part of ``h5py.Dataset`` the backends use, over a numpy array kept
    in the index."""

    def __init__(self, array: np.ndarray):
        self.a = np.asarray(array)

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, value):
        self.a[idx] = value


class _RowDataset:
    """A growable dataset kept as a raw file of rows: ``resize`` truncates or
    extends the file, and a write touches only the rows it names, so an
    append costs one chunk whatever the chain's length."""

    def __init__(self, path: str, dtype, row_shape):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.row_shape = tuple(int(n) for n in row_shape)
        self.row_bytes = self.dtype.itemsize * int(np.prod(self.row_shape, dtype=np.int64))

    @property
    def shape(self):
        return (os.path.getsize(self.path) // self.row_bytes,) + self.row_shape

    def _map(self, mode: str):
        shape = self.shape
        if shape[0] == 0:
            return np.zeros(shape, self.dtype)
        return np.memmap(self.path, self.dtype, mode, shape=shape)

    def __getitem__(self, idx):
        return np.array(self._map("r")[idx])

    def __setitem__(self, idx, value):
        rows = self._map("r+")
        rows[idx] = value
        if isinstance(rows, np.memmap):
            rows.flush()

    def resize(self, n: int, axis: int = 0) -> None:
        os.truncate(self.path, n * self.row_bytes)


class _DirGroup:
    """The part of ``h5py.Group`` the backends use."""

    def __init__(self, dirname: str, prefix: str = ""):
        self.dirname = dirname
        self.prefix = prefix
        self.attrs: dict = {}
        self.children: dict = {}

    def __contains__(self, name):
        return name in self.children

    def __getitem__(self, name):
        return self.children[name]

    def __delitem__(self, name):
        del self.children[name]

    def get(self, name, default=None):
        return self.children.get(name, default)

    def keys(self):
        return self.children.keys()

    def items(self):
        return self.children.items()

    def create_group(self, name):
        self.children[name] = _DirGroup(self.dirname, f"{self.prefix}{name}/")
        return self.children[name]

    def require_group(self, name):
        return self.children[name] if name in self.children else self.create_group(name)

    def _rows(self, name, dtype, row_shape) -> _RowDataset:
        path = os.path.join(self.dirname, (self.prefix + name).replace("/", ".") + ".bin")
        return _RowDataset(path, dtype, row_shape)

    def create_dataset(self, name, shape=None, maxshape=None, dtype=None, data=None, **_):
        data = np.zeros(shape, dtype=dtype or np.float64) if data is None else np.asarray(data, dtype=dtype)
        if maxshape is None:
            self.children[name] = _SmallDataset(data.copy())
        else:
            ds = self._rows(name, data.dtype, data.shape[1:])
            with open(ds.path, "wb") as f:
                f.write(np.ascontiguousarray(data).tobytes())
            self.children[name] = ds
        return self.children[name]


class _DirFile(_DirGroup):
    """An h5py-like file kept as a directory.  Datasets created with
    ``maxshape`` are raw row files (``<group>.<name>.bin``); attributes,
    small datasets and the row files' dtypes and row shapes go into
    ``index.npz``, rewritten atomically when a writer closes.  Row files are
    written in place before the index, so a torn append leaves rows past the
    committed ``iteration``, as with h5py."""

    def __init__(self, dirname: str, mode: str = "r"):
        super().__init__(dirname)
        self.mode = mode
        index = os.path.join(dirname, _INDEX)
        if not os.path.isfile(index):
            if mode == "r":
                raise FileNotFoundError(dirname)
            os.makedirs(dirname, exist_ok=True)
            return
        with np.load(index, allow_pickle=False) as z:
            for key in z.files:
                # "<path>@<attr>", "<path>" (small dataset), "<path>%" (row file)
                path, _, attr = key.partition("@")
                parts = [p for p in path.rstrip("%").split("/") if p]
                node = self
                for p in parts[: len(parts) - (0 if attr else 1)]:
                    node = node.require_group(p)
                if attr:
                    node.attrs[attr] = z[key][()]
                elif path.endswith("%"):
                    node.children[parts[-1]] = node._rows(parts[-1], z[key].dtype, z[key].shape[1:])
                else:
                    node.children[parts[-1]] = _SmallDataset(z[key])

    def _flatten(self, group: _DirGroup, out: dict) -> None:
        for k, v in group.attrs.items():
            out[f"{group.prefix}@{k}"] = np.asarray(v)
        for name, child in group.children.items():
            if isinstance(child, _DirGroup):
                self._flatten(child, out)
            elif isinstance(child, _RowDataset):
                out[f"{group.prefix}{name}%"] = np.zeros((0,) + child.row_shape, child.dtype)
            else:
                out[group.prefix + name] = child.a

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.mode != "r" and exc[0] is None:
            arrays: dict = {}
            self._flatten(self, arrays)
            tmp = os.path.join(self.dirname, "index.tmp.npz")
            np.savez(tmp, **arrays)
            os.replace(tmp, os.path.join(self.dirname, _INDEX))
        return False


class _DirModule:
    File = _DirFile
    Dataset = _SmallDataset


def _h5():
    """h5py, or the directory store with the same interface when h5py is
    missing."""
    try:
        import h5py
    except ImportError:
        return _DirModule
    return h5py


def store_kind() -> str:
    return "dir" if _h5() is _DirModule else "hdf5"


def _dir_store_at(filename: str) -> bool:
    return os.path.isfile(os.path.join(filename + ".d", _INDEX))


class _Store:
    """Where a chain's bytes live: the HDF5 file ``filename`` when h5py can
    be imported, else the directory ``filename.d``.  A directory store
    written where h5py was missing (the card) is read, and extended, where
    h5py exists, as long as ``filename`` itself is not there: every read and
    write looks the store up again, so a store copied in later is found."""

    def __init__(self, filename: str):
        self.filename = filename

    def _where(self):
        h5 = _h5()
        if h5 is _DirModule or (not os.path.isfile(self.filename) and _dir_store_at(self.filename)):
            return _DirModule, self.filename + ".d"
        return h5, self.filename

    @property
    def path(self) -> str:
        return self._where()[1]

    def _open(self, mode: str):
        h5, path = self._where()
        return h5.File(path, mode)

    def exists(self) -> bool:
        h5, path = self._where()
        if h5 is _DirModule:
            return os.path.isfile(os.path.join(path, _INDEX))
        return os.path.isfile(path)

    def save_state(self, blob: dict) -> None:
        """Rewrite the exact-resume ``sampler_state`` group."""
        h5, path = self._where()
        with h5.File(path, "a") as f:
            g = f.require_group(STATE_GROUP)
            for k, v in blob.items():
                v = np.asarray(v)
                ds = g.get(k)
                if isinstance(ds, h5.Dataset) and ds.shape == v.shape and ds.dtype == v.dtype:
                    # overwrite in place: HDF5 never reclaims freed space
                    ds[...] = v
                else:
                    if ds is not None:
                        del g[k]
                    g.create_dataset(k, data=v)
            for k in list(g.keys()):
                if k not in blob:
                    del g[k]

    def load_state(self) -> Optional[dict]:
        if not self.exists():
            return None
        with self._open("r") as f:
            if STATE_GROUP not in f:
                return None
            return {k: np.asarray(v[()]) for k, v in f[STATE_GROUP].items()}


def export_hdf5(store_path: str, h5_path: str) -> None:
    """Write a directory store (``<name>.d``, or the chain name beside it)
    as the HDF5 file ``h5_path`` with the same groups, datasets, attributes
    and ``sampler_state``: the layout the JAX package's backends read.
    Growable datasets stay growable, so the file can be resumed."""
    import h5py

    if not os.path.isfile(os.path.join(store_path, _INDEX)) and _dir_store_at(store_path):
        store_path = store_path + ".d"
    src = _DirFile(store_path, "r")

    def copy(node: _DirGroup, dst) -> None:
        for k, v in node.attrs.items():
            v = np.asarray(v)
            # h5py stores no numpy unicode: a string attribute goes in as str
            dst.attrs[k] = v.item() if v.dtype.kind == "U" and v.ndim == 0 else v
        for name, child in node.children.items():
            if isinstance(child, _DirGroup):
                copy(child, dst.create_group(name))
            elif isinstance(child, _RowDataset):
                dst.create_dataset(name, data=child[:], maxshape=(None,) + child.row_shape,
                                   chunks=True, compression="gzip")
            else:
                dst.create_dataset(name, data=child.a)

    tmp = h5_path + ".tmp"
    with h5py.File(tmp, "w") as f:
        copy(src, f)
    os.replace(tmp, h5_path)


class EmceeBackend(_Store):
    """Grow-on-write emcee-layout store."""

    def __init__(self, filename: str, name: str = "mcmc"):
        super().__init__(filename)
        self.name = name

    @property
    def initialized(self) -> bool:
        """True only when the file holds at least one step."""
        if not self.exists():
            return False
        with self._open("r") as f:
            return self.name in f and int(f[self.name].attrs.get("iteration", 0)) > 0

    @property
    def iteration(self) -> int:
        with self._open("r") as f:
            return int(f[self.name].attrs["iteration"])

    def reset(self, nwalkers: int, ndim: int) -> None:
        with self._open("a") as f:
            if self.name in f:
                del f[self.name]
            g = f.create_group(self.name)
            g.attrs["nwalkers"] = nwalkers
            g.attrs["ndim"] = ndim
            g.attrs["iteration"] = 0
            g.attrs["has_blobs"] = False
            g.attrs["version"] = "3.0.2"
            for dsname, shape in (
                ("chain", (0, nwalkers, ndim)),
                ("chain_transformed", (0, nwalkers, ndim)),
                ("log_prob", (0, nwalkers)),
            ):
                g.create_dataset(dsname, shape, maxshape=(None,) + shape[1:], dtype=np.float64)
            g.create_dataset("accepted", data=np.zeros(nwalkers))

    def append(
        self,
        chain: np.ndarray,
        log_prob: np.ndarray,
        accepted: np.ndarray,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> None:
        n = chain.shape[0]
        transformed = transform(chain) if transform is not None else chain
        with self._open("a") as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            for dsname, arr in (
                ("chain", chain),
                ("chain_transformed", transformed),
                ("log_prob", log_prob),
            ):
                g[dsname].resize(it + n, axis=0)
                g[dsname][it : it + n] = arr
            # iteration before the acceptance counters: a crash between them
            # undercounts one chunk's acceptances instead of double-counting
            g.attrs["iteration"] = it + n
            g["accepted"][:] = g["accepted"][:] + accepted

    def get_value(self, name: str, flat: bool = False, discard: int = 0, thin: int = 1):
        with self._open("r") as f:
            g = f[self.name]
            v = g[name][discard + thin - 1 : int(g.attrs["iteration"]) : thin]
        return v.reshape((-1,) + v.shape[2:]) if flat else v

    def get_chain(self, **kwargs) -> np.ndarray:
        return self.get_value("chain", **kwargs)

    def get_log_prob(self, **kwargs) -> np.ndarray:
        return self.get_value("log_prob", **kwargs)

    def get_last_sample(self) -> np.ndarray:
        with self._open("r") as f:
            g = f[self.name]
            return np.copy(g["chain"][int(g.attrs["iteration"]) - 1])


class ZeusBackend(_Store):
    """Append-only zeus-layout store (root datasets, gzip)."""

    @staticmethod
    def _committed(f) -> int:
        """Committed step count: the root ``iteration`` attribute, else
        (older files) the shortest dataset, a missing one counting 0."""
        if "iteration" in f.attrs:
            return int(f.attrs["iteration"])
        return min(
            int(f[k].shape[0]) if k in f else 0
            for k in ("samples", "chain_transformed", "logprob")
        )

    @property
    def initialized(self) -> bool:
        if not self.exists():
            return False
        with self._open("r") as f:
            return "samples" in f and self._committed(f) > 0

    @property
    def iteration(self) -> int:
        with self._open("r") as f:
            return self._committed(f)

    def append(
        self,
        chain: np.ndarray,
        log_prob: np.ndarray,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> None:
        transformed = transform(chain) if transform is not None else chain
        with self._open("a") as f:
            n0 = self._committed(f) if "samples" in f else 0
            for dsname, arr in (
                ("samples", chain),
                ("chain_transformed", transformed),
                ("logprob", log_prob),
            ):
                if dsname not in f:
                    f.create_dataset(
                        dsname, data=arr, compression="gzip", chunks=True,
                        maxshape=(None,) + arr.shape[1:],
                    )
                    continue
                ds = f[dsname]
                # resize from the committed count: rows past it are a torn
                # previous append and are overwritten
                ds.resize(n0 + arr.shape[0], axis=0)
                ds[n0:] = arr
            f.attrs["iteration"] = n0 + chain.shape[0]

    def get_value(self, name: str, flat: bool = False, discard: int = 0, thin: int = 1):
        with self._open("r") as f:
            v = f[name][discard + thin - 1 : self._committed(f) : thin]
        return v.reshape((-1,) + v.shape[2:]) if flat else v

    def get_chain(self, **kwargs) -> np.ndarray:
        return self.get_value("samples", **kwargs)

    def get_log_prob(self, **kwargs) -> np.ndarray:
        return self.get_value("logprob", **kwargs)

    def get_last_sample(self) -> np.ndarray:
        with self._open("r") as f:
            return np.copy(f["samples"][self._committed(f) - 1])
