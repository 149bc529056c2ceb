"""Fused emulator kernels: the trunk forward and the full walker likelihood.

Counterpart of ``linna_tpu/ops/fused.py``, whose two Pallas TPU kernels
become hand-written CUDA C++ for Hopper (``csrc/fused_mlp.cu``, built for
``sm_90a`` with ``nvcc`` at first use and called through ``ctypes``):

- ``fused_apply`` (replaces ``_apply_impl``): the whole ChtoModelv2 trunk in
  one cooperative launch of tiled 3xTF32 tensor-core products, with the
  activations between products in a scratch buffer the wrapper allocates.
- ``fused_log_prob`` (replaces ``_log_prob_impl``): whitened walker position
  -> prior transform -> standardize -> trunk -> destandardize (exp when
  ``ypositive``) -> sigma scale -> chi^2 against the data with the inverse
  covariance -> tempered posterior + unit-normal prior, one f32 per walker.

``fused_log_prob``'s kernel runs on thread-block clusters of 8 blocks that
split every product's columns and exchange activations through distributed
shared memory; it raises when no cluster of its shape fits on the card.
``launch_shape`` reports each kernel's launch.

Each wrapper launches its kernel for a CUDA tensor and raises if the build or
the launch fails; for a CPU tensor it runs the plain PyTorch version beside
it (``fused_apply_plain``, ``fused_log_prob_plain``).  ``launches`` counts
kernel launches and ``plain_calls`` plain-version calls, so a run can show
which one its main path took.  Gradients recompute the plain composition
under autograd (``torch.autograd.Function``), as the JAX custom VJPs do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import nn as N

__all__ = [
    "fused_apply",
    "fused_apply_plain",
    "fused_log_prob",
    "fused_log_prob_plain",
    "build",
    "launch_shape",
    "launches",
    "plain_calls",
    "reset_counts",
]

SOURCE = Path(__file__).parent / "csrc" / "fused_mlp.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: Dict[str, int] = {"fused_apply": 0, "fused_log_prob": 0}
plain_calls: Dict[str, int] = {"fused_apply": 0, "fused_log_prob": 0}


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------------ build


class _Library:
    """The built shared library and its compiler output."""

    lib: Optional[ctypes.CDLL] = None
    log: str = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the fused "
            "CUDA kernels are built from source at first use"
        )
    return found


# linna_launch_shape's kernel ids
_KERNEL_IDS = {"fused_apply": 0, "fused_log_prob": 1}


def build() -> str:
    """Compile ``csrc/fused_mlp.cu`` into ``_build/`` (cached by a hash of
    the source and flags) and load it.  Returns the compiler output
    (``-Xptxas -v``: registers and shared memory per kernel).  Raises with
    the compiler output when ``nvcc`` fails."""
    if _Library.lib is not None:
        return _Library.log
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libfused_mlp_{tag}.so"
    log_path = so.with_suffix(".log")
    if not so.is_file():
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.linna_fused_apply.argtypes = [vp, ci, ptrs, ints, vp, vp, ctypes.c_longlong, vp]
    lib.linna_fused_apply.restype = ci
    lib.linna_apply_scratch_floats.argtypes = [ci, ints]
    lib.linna_apply_scratch_floats.restype = ctypes.c_longlong
    lib.linna_fused_log_prob.argtypes = [vp, ci, ptrs, ints, ptrs, ci, vp, vp]
    lib.linna_fused_log_prob.restype = ci
    lib.linna_launch_shape.argtypes = [ci, ci, ints, ints, ctypes.POINTER(ctypes.c_longlong)]
    lib.linna_launch_shape.restype = ci
    lib.linna_error_string.argtypes = [ci]
    lib.linna_error_string.restype = ctypes.c_char_p
    _Library.lib = lib
    _Library.log = log_path.read_text() if log_path.is_file() else ""
    return _Library.log


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _Library.lib.linna_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


# ------------------------------------------------------- weights and shapes


def _flatten_params(params) -> List[torch.Tensor]:
    """Flat weight list in the JAX package's ``_flatten_params`` order."""
    out = [params["layer1"]["w"], params["layer1"]["b"]]
    for rb in ("rb1", "rb2", "rb3"):
        p = params[rb]
        out += [p["lin1"]["w"], p["lin1"]["b"], p["lin2"]["w"], p["lin2"]["b"], p["skip_w"]]
    for layer in ("layer6", "layer7", "layer8"):
        out += [params[layer]["w"], params[layer]["b"]]
    return out


def _dims(spec: N.ModelSpec) -> List[int]:
    """The kernel's layer widths: in, h, h/2, h/4, h/8, c, 2c, 4c, layer6, out."""
    h, h2, h4, h8 = spec.widths
    c = spec.channel
    l6 = h8 * 4 if spec.name != "chto_simple" else h8
    return [spec.in_size, h, h2, h4, h8, c, 2 * c, 4 * c, l6, spec.out_size]


def _reject_bypass(spec: N.ModelSpec, what: str, instead: str) -> None:
    if spec.linear_bypass:
        raise ValueError(
            f"{what} not implement chto_v2_linear's 1e-3 linear "
            f"bypass; use {instead} for that spec"
        )


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_weights(spec: N.ModelSpec, weights: Sequence[torch.Tensor], device) -> List[int]:
    dims = _dims(spec)
    i, h, h2, h4, h8, c1, c2, c3, l6, out = dims
    shapes = [(i, h), (h,)]
    for fin, ch, fout in ((h, c1, h2), (h2, c2, h4), (h4, c3, h8)):
        shapes += [(fin, ch), (ch,), (ch, fout), (fout,), (fin, fout)]
    shapes += [(h8, l6), (l6,), (l6, out), (out,), (out, out), (out,)]
    for k, (w, s) in enumerate(zip(weights, shapes)):
        _require(w, f"weight {k}", torch.float32, s, device)
    return dims


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def launch_shape(spec: N.ModelSpec, nrows: int, kernel: str) -> Dict[str, int]:
    """The launch shape of ``kernel`` over ``nrows`` walkers (its occupancy
    record).  ``fused_apply`` is one cooperative launch: the output tile
    (rows, columns, k per stage, stages), blocks, threads, blocks per SM,
    the card's SMs, each product's k split over blocks, the most work items
    (tiles x split) of any product, and dynamic shared memory per block.  ``fused_log_prob`` runs on clusters: walkers per
    cluster, blocks per cluster, clusters, blocks, threads, shared memory,
    and the most clusters of that shape the card holds at once."""
    build()
    dims = (ctypes.c_int * 10)(*_dims(spec))
    shape, smem = (ctypes.c_int * 19)(), ctypes.c_longlong()
    err = _Library.lib.linna_launch_shape(
        _KERNEL_IDS[kernel], nrows, dims, shape, ctypes.byref(smem)
    )
    if err != 0:
        msg = _Library.lib.linna_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch-shape query failed: {msg} (cudaError {err})")
    if kernel == "fused_apply":
        tile_rows, tile_cols, blocks, threads, per_sm, sms, tile_k, stages, items = shape[:9]
        return {"tile": [tile_rows, tile_cols, tile_k], "stages": stages, "blocks": blocks,
                "threads_per_block": threads, "blocks_per_sm": per_sm, "sms": sms,
                "split": list(shape[9:]), "max_items": items, "smem_bytes": smem.value}
    walkers, cluster, blocks, threads, max_clusters = shape[:5]
    return {
        "walkers_per_cluster": walkers,
        "cluster_size": cluster,
        "clusters": blocks // cluster,
        "blocks": blocks,
        "threads_per_block": threads,
        "smem_bytes": smem.value,
        "max_active_clusters": max_clusters,
    }


def _recompute_grads(fn: Callable, inputs: Sequence, needs: Sequence[bool], grad_out):
    """Gradients of ``fn(*inputs)`` by autograd of the plain composition,
    recomputed in the backward pass."""
    with torch.enable_grad():
        leaves = [
            t.detach().requires_grad_(bool(n)) if torch.is_tensor(t) else t
            for t, n in zip(inputs, needs)
        ]
        out = fn(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
    return [next(grads) if n else None for n in needs]


# ---------------------------------------------------------- fused forward


def _trunk_plain(x: torch.Tensor, w: Sequence[torch.Tensor]) -> torch.Tensor:
    """The trunk on the flat weight list, with ``nn.apply_model``'s
    arithmetic (each product's bias or skip added before its rounding)."""
    s = torch.relu(N._affine(w[1], x, w[0]))
    i = 2
    for _ in range(3):
        l1w, l1b, l2w, l2b, skw = w[i : i + 5]
        i += 5
        h = torch.relu(N._affine(l1b, s, l1w))
        s = torch.relu(N._affine(N._scaled(N._affine(l2b, h, l2w), 0.1), s, skw))
    s = torch.relu(N._affine(w[i + 1], s, w[i]))
    s = torch.relu(N._affine(w[i + 3], s, w[i + 2]))
    return N._affine(w[i + 5], s, w[i + 4])


def fused_apply_plain(spec: N.ModelSpec, params, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``fused_apply`` kernel."""
    _reject_bypass(spec, "fused kernels do", "nn.apply_model (the XLA path)")
    plain_calls["fused_apply"] += 1
    return _trunk_plain(x.to(torch.float32), _flatten_params(params))


def _launch_apply(spec: N.ModelSpec, x: torch.Tensor, weights) -> torch.Tensor:
    build()
    dims = (ctypes.c_int * 10)(*_check_weights(spec, weights, x.device))
    _require(x, "x", torch.float32, (x.shape[0], spec.in_size), x.device)
    out = torch.empty((x.shape[0], spec.out_size), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # the activations between the kernel's products and the partial
        # tiles of the products it splits over blocks
        floats = _Library.lib.linna_apply_scratch_floats(x.shape[0], dims)
        if floats < 0:
            _check(-floats, "fused_apply")
        scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _Library.lib.linna_fused_apply(
            x.data_ptr(), x.shape[0], _ptrs(weights), dims, out.data_ptr(),
            scratch.data_ptr(), floats, stream,
        )
    _check(err, "fused_apply")
    launches["fused_apply"] += 1
    return out


class _FusedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x, *weights):
        ctx.save_for_backward(x, *weights)
        return _launch_apply(spec, x, weights)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        grads = _recompute_grads(
            lambda xx, *ww: _trunk_plain(xx, ww), inputs, ctx.needs_input_grad[1:], g
        )
        return (None, *grads)


def fused_apply(spec: N.ModelSpec, params, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`linna_tpu_torch.nn.apply_model` (no linearmodel)
    running the whole trunk as one CUDA kernel; the plain version for a CPU
    tensor."""
    _reject_bypass(spec, "fused kernels do", "nn.apply_model (the XLA path)")
    if not x.is_cuda:
        return fused_apply_plain(spec, params, x)
    x = x.to(torch.float32).contiguous()
    return _FusedApply.apply(spec, x, *_flatten_params(params))


# ------------------------------------------------------- fused likelihood


def _like_tensors(env) -> List[torch.Tensor]:
    pk, ts = env["priors"], env["transforms"]
    xt, yt = ts.x_transform, ts.y_transform
    return [
        pk.is_gauss, pk.arg1, pk.arg2, xt.mean, xt.std, xt.log10_mask,
        yt.mean, yt.std, ts.y_data.sigma, env["data"], env["inv_cov"],
        env["temperature"],
    ]


def fused_log_prob_plain(spec: N.ModelSpec, x: torch.Tensor, env, ypositive: bool) -> torch.Tensor:
    """Plain PyTorch version of the ``fused_log_prob`` kernel: the seven
    steps of the kernel on an env of :func:`likelihood.make_log_prob`."""
    plain_calls["fused_log_prob"] += 1
    is_gauss, a1, a2, xm, xs, xl, ym, ys, sg, data, ic, temp = _like_tensors(env)
    xw = x.to(torch.float32)
    u = 0.5 * (1.0 + torch.special.erf(xw / 1.4142135623730951))
    x_phys = torch.where(is_gauss, xw * a2 + a1, u * (a2 - a1) + a1)
    bad = torch.any(xl & (x_phys <= 0.0), dim=-1)
    x_in = torch.where(xl, torch.log10(torch.clamp(x_phys, min=1e-30)), x_phys)
    pred = _trunk_plain((x_in - xm) / xs, _flatten_params(env["params"]))
    m = pred * ys + ym
    if ypositive:
        m = torch.exp(m)
    delta = m * sg - data
    chi2 = torch.sum((delta @ ic) * delta, dim=-1)
    lp = -0.5 * chi2 * (1.0 / temp) - 0.5 * torch.sum(xw * xw, dim=-1)
    return torch.where(torch.isnan(lp) | bad, torch.full_like(lp, -torch.inf), lp)


class _LaunchArgs:
    """The validated ctypes arguments of one env's launches.  Checked and
    built again only when a tensor of the env is replaced; in-place updates
    keep them valid.  The sampler calls the kernel tens of times per step
    with one env, and checking 35 tensors per call costs more host time than
    the launch."""

    def __init__(self, spec: N.ModelSpec):
        self.spec = spec
        self.key = None

    def get(self, env):
        weights = _flatten_params(env["params"])
        like = _like_tensors(env)
        key = tuple(id(t) for t in weights) + tuple(id(t) for t in like)
        if key != self.key:
            device = env["data"].device
            dims = _check_weights(self.spec, weights, device)
            d, n = self.spec.in_size, self.spec.out_size
            names = ("is_gauss", "arg1", "arg2", "x_mean", "x_std", "log10_mask",
                     "y_mean", "y_std", "sigma", "data", "inv_cov", "temperature")
            shapes = [(d,)] * 6 + [(n,)] * 4 + [(n, n), ()]
            dtypes = [torch.bool] + [torch.float32] * 4 + [torch.bool] + [torch.float32] * 6
            for t, name, shape, dt in zip(like, names, shapes, dtypes):
                _require(t, name, dt, shape, device)
            self.tensors = weights + like  # keeps the pointed-to tensors alive
            self.device = device
            self.arrays = (_ptrs(weights), (ctypes.c_int * 10)(*dims), _ptrs(like))
            self.key = key
        return self.arrays


def _launch_log_prob(spec: N.ModelSpec, x: torch.Tensor, env, ypositive: bool,
                     args: _LaunchArgs) -> torch.Tensor:
    build()
    weights, dims, like = args.get(env)
    _require(x, "x", torch.float32, (x.shape[0], spec.in_size), args.device)
    lp = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _Library.lib.linna_fused_log_prob(
            x.data_ptr(), x.shape[0], weights, dims, like, int(bool(ypositive)),
            lp.data_ptr(), stream,
        )
    _check(err, "fused_log_prob")
    launches["fused_log_prob"] += 1
    return lp


def _tree_tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of an env (dicts and named tuples), in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_tensors(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in _tree_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def _tree_rebuild(tree, leaves):
    """``tree`` with its tensor leaves replaced, in :func:`_tree_tensors` order."""
    if isinstance(tree, dict):
        return {k: _tree_rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_rebuild(v, leaves) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return next(leaves) if torch.is_tensor(tree) else tree


class _FusedLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, x, *env_leaves):
        spec, ypositive, env, _, args = meta
        ctx.meta = meta
        ctx.save_for_backward(x, *env_leaves)
        return _launch_log_prob(spec, x, env, ypositive, args)

    @staticmethod
    def backward(ctx, g):
        _, _, env, ref_pure, _ = ctx.meta
        inputs = ctx.saved_tensors

        def plain(xx, *leaves):
            return ref_pure(xx, _tree_rebuild(env, iter(leaves)))

        grads = _recompute_grads(plain, inputs, ctx.needs_input_grad[1:], g)
        return (None, *grads)


def fused_log_prob(
    spec: N.ModelSpec,
    params,
    transforms,
    prior_pack,
    data,
    inv_cov,
    temperature: float = 1.0,
    device=None,
):
    """Build the fused batched log-posterior (W, D) -> (W,).

    Semantics match :func:`linna_tpu_torch.likelihood.make_log_prob` with
    the default Gaussian likelihood and no external terms, including
    log10(x <= 0) -> -inf.  The callable carries the same ``_pure``/``_env``
    pair; its gradient (walkers and env) is autograd of the plain
    composition, recomputed in the backward pass."""
    _reject_bypass(spec, "fused_log_prob does", "make_log_prob's XLA path")
    from .. import likelihood as LK

    reference = LK.make_log_prob(
        spec, params, transforms, prior_pack, data, inv_cov,
        temperature=temperature, device=device,
    )
    ref_pure, env = reference._pure, reference._env
    ypositive = bool(transforms.y_transform.ypositive)
    args = _LaunchArgs(spec)

    def lp_pure(x: torch.Tensor, env) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=env["data"].device)
        if not x.is_cuda:
            return fused_log_prob_plain(spec, x, env, ypositive)
        x = x.contiguous()
        if torch.is_grad_enabled():
            leaves = _tree_tensors(env)
            if x.requires_grad or any(t.requires_grad for t in leaves):
                meta = (spec, ypositive, env, ref_pure, args)
                return _FusedLogProb.apply(meta, x, *leaves)
        return _launch_log_prob(spec, x, env, ypositive, args)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return lp_pure(x, env)

    log_prob._pure = lp_pure
    log_prob._env = env
    # the plain composition over the same env, for what cannot trace the
    # kernel's autograd.Function (torch.func's Hessian of the MAP search)
    log_prob._plain_pure = ref_pure
    return log_prob
