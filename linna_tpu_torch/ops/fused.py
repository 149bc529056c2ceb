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

``fused_log_prob`` has two designs, chosen by the model's widths alone
(:func:`log_prob_design`): thread-block clusters of 8 blocks that keep the
activations in distributed shared memory, where a cluster holds 16 walkers
or more (the DES width), and elsewhere (the LSST width) one cooperative
launch of the same tiled tensor-core products as ``fused_apply``, planned
here, on the host, by :func:`log_prob_plan`: a pure function of the widths
and the rows (and of what the card holds at once), whose k split of every
product follows the widths alone.  In both a row's value does not depend on
the rows launched beside it.  ``launch_shape`` reports each kernel's launch.

Each wrapper launches its kernel for a CUDA tensor and raises if the build or
the launch fails; for a CPU tensor it runs the plain PyTorch version beside
it (``fused_apply_plain``, ``fused_log_prob_plain``).  Either counts itself
in :mod:`linna_tpu_torch.ops.library`'s counters, with the shape it ran at.
Gradients recompute the plain composition under autograd
(``torch.autograd.Function``), as the JAX custom VJPs do.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import nn as N
from .library import KernelLibrary, require
# the counters, bound here too: benchmark/kinds.py reads them from this module
from .library import (LIKELIHOOD_KERNELS, designs, launch_shapes, launches,  # noqa: F401
                      plain_calls, plain_shapes, reset_counts)

__all__ = [
    "fused_apply",
    "fused_apply_plain",
    "fused_log_prob",
    "fused_log_prob_plain",
    "build",
    "LIBRARY",
    "launch_shape",
    "log_prob_design",
    "log_prob_plan",
    "launches",
    "designs",
    "plain_calls",
    "launch_shapes",
    "plain_shapes",
    "reset_counts",
]

SOURCE = Path(__file__).parent / "csrc" / "fused_mlp.cu"


def build() -> str:
    """Build and load ``csrc/fused_mlp.cu`` once per process; returns the
    compiler output (registers and shared memory per kernel)."""
    return LIBRARY.build()


# ------------------------------------------------------- weights and shapes


def flatten_params(params) -> List[torch.Tensor]:
    """Flat weight list in the JAX package's ``_flatten_params`` order."""
    out = [params["layer1"]["w"], params["layer1"]["b"]]
    for rb in ("rb1", "rb2", "rb3"):
        p = params[rb]
        out += [p["lin1"]["w"], p["lin1"]["b"], p["lin2"]["w"], p["lin2"]["b"], p["skip_w"]]
    for layer in ("layer6", "layer7", "layer8"):
        out += [params[layer]["w"], params[layer]["b"]]
    return out


def kernel_dims(spec: N.ModelSpec) -> List[int]:
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


def weight_shapes(dims: Sequence[int], members: int = 1) -> List[tuple]:
    """The 23 weights' shapes in ``flatten_params`` order; stacked over
    ``members`` > 1 as ``make_log_prob`` stacks them ((K, in, out) and
    biases (K, 1, out))."""
    i, h, h2, h4, h8, c1, c2, c3, l6, out = dims
    shapes = [(i, h), (h,)]
    for fin, ch, fout in ((h, c1, h2), (h2, c2, h4), (h4, c3, h8)):
        shapes += [(fin, ch), (ch,), (ch, fout), (fout,), (fin, fout)]
    shapes += [(h8, l6), (l6,), (l6, out), (out,), (out, out), (out,)]
    if members > 1:
        shapes = [(members, *s) if len(s) == 2 else (members, 1, *s) for s in shapes]
    return shapes


def check_weights(spec: N.ModelSpec, weights: Sequence[torch.Tensor], device,
                   members: int = 1) -> List[int]:
    dims = kernel_dims(spec)
    for k, (w, s) in enumerate(zip(weights, weight_shapes(dims, members))):
        require(w, f"weight {k}", torch.float32, s, device)
    return dims


def pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


# ------------------------------------------------ fused_log_prob's launch plan

# csrc/fused_mlp.cu: an output tile's rows, columns and k-chunk, its threads,
# the fewest k-chunks of a part of a split product
TILE_ROWS, TILE_COLS, TILE_K, TILE_THREADS = 64, 64, 32, 128
MIN_SPLIT_CHUNKS = 2
# Each product's k split is planned for this many row tiles (128 rows,
# zeus's half-ensemble) to give about SPLIT_ITEMS work items, two an SM of
# the H100; it follows the widths alone, whatever the rows of a launch.
SPLIT_ROW_TILES = 2
SPLIT_ITEMS = 264
# the H100 SXM: SMs and blocks of the kernel an SM holds (255 registers a
# thread, 92,160 bytes of shared memory a block); the card's own numbers
# replace them on a card (log_prob_capacity)
H100 = (132, 2)
PLAN_HEAD, PLAN_PRODUCT, LIKE_PRODUCTS = 11, 5, 11
PLAN_LENGTH = PLAN_HEAD + PLAN_PRODUCT * LIKE_PRODUCTS

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ptrs_t, _ints, _lls = ctypes.POINTER(_vp), ctypes.POINTER(_ci), ctypes.POINTER(_ll)
LIBRARY = KernelLibrary(SOURCE, {
    "linna_fused_apply": ([_vp, _ci, _ptrs_t, _ints, _vp, _vp, _ll, _vp], _ci),
    "linna_apply_scratch_floats": ([_ci, _ints], _ll),
    "linna_fused_log_prob": ([_vp, _ci, _ptrs_t, _ints, _ptrs_t, _ci, _vp, _vp, _ll, _vp, _vp],
                             _ci),
    "linna_log_prob_capacity": ([_ints, _ints, _lls], _ci),
    "linna_apply_launch_shape": ([_ci, _ints, _ints, _lls], _ci),
    "linna_fused_log_prob_cluster": ([_vp, _ci, _ptrs_t, _ints, _ptrs_t, _ci, _vp, _vp], _ci),
    "linna_cluster_launch_shape": ([_ci, _ints, _ints, _lls], _ci),
    "linna_cluster_walkers": ([_ints], _ci),
    # composition_grad_kernel (ops/composition.py)
    "linna_composition_grad": ([_vp, _ci, _ci, _ptrs_t, _ptrs_t, _ints, _ptrs_t, _ci, _vp, _lls,
                                _vp, _ll, _vp, _vp, _vp], _ci),
    "linna_composition_grad_capacity": ([_ints, _ints, _lls], _ci),
    "linna_composition_grad_plan_length": ([], _ci),
}, error="linna_error_string", abi=("linna_log_prob_plan_length", PLAN_LENGTH))
# fused_log_prob_kernel on this card: (SMs, blocks an SM holds, shared bytes a block)
_capacity: Optional[tuple] = None


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round4(v: int) -> int:
    return (v + 3) & ~3


def log_prob_products(dims: Sequence[int]) -> List[tuple]:
    """``fused_log_prob``'s 11 products on the kernel's widths (``kernel_dims``):
    (K, the output widths of its segments): layer 1, the residual blocks'
    lin1 | skip and lin2, layers 6, 7 and 8, then the chi^2 product."""
    i, h, h2, h4, h8, c1, c2, c3, l6, out = dims
    return [(i, (h,)), (h, (c1, h2)), (c1, (h2,)), (h2, (c2, h4)), (c2, (h4,)),
            (h4, (c3, h8)), (c3, (h8,)), (h8, (l6,)), (l6, (out,)), (out, (out,)),
            (out, (out,))]


def k_split(k: int, widths: Sequence[int], row_tiles: int, members: int = 1) -> int:
    """A product's k split: the parts of at least ``MIN_SPLIT_CHUNKS``
    chunks that bring its tiles (``members`` times its segments' column
    tiles at ``row_tiles`` row tiles) nearest ``SPLIT_ITEMS`` work items."""
    col_tiles = sum(cdiv(n, TILE_COLS) for n in widths)
    most = cdiv(k, TILE_K) // MIN_SPLIT_CHUNKS
    return max(1, min(SPLIT_ITEMS // (row_tiles * col_tiles * members), most))


def log_prob_splits(dims: Sequence[int]) -> List[int]:
    """Each product's k split (:func:`k_split` at ``SPLIT_ROW_TILES`` row
    tiles).  A function of the widths alone."""
    return [k_split(k, widths, SPLIT_ROW_TILES) for k, widths in log_prob_products(dims)]


def log_prob_plan(dims: Sequence[int], nrows: int, sms: int = H100[0],
                  per_sm: int = H100[1]) -> dict:
    """The launch of ``fused_log_prob_kernel`` over ``nrows`` rows on a card
    of ``sms`` SMs that hold ``per_sm`` blocks each.

    Every product's tiles (64 x 64, ``row_tiles`` down the rows, its
    segments' ``col_tiles`` across) and k split (:func:`log_prob_splits`,
    part q of a split product takes k-chunks [q nk / split, (q + 1) nk /
    split)).  The grid is as many blocks as the product with the most work
    items (tiles x split) has, at most all that the card holds at once (a
    cooperative launch); so its size tells the sampler's launches of 1, 128
    and 256 rows apart.  A split product whose tiles alone fill the grid is
    ``local``: one block sums a tile's parts in order, as the partial tiles
    of the others are summed after a grid barrier, to the same bits.
    ``floats``: the scratch's layout in floats (the activation buffers A, B,
    H, layer 1's input X, the partial tiles or the local products' slabs,
    one a block); ``array`` the plan as the kernel takes it."""
    dims = [int(v) for v in dims]
    i, h, h2, h4, h8, c1, c2, c3, l6, out = dims
    row_tiles = cdiv(nrows, TILE_ROWS)
    capacity = sms * per_sm
    products = []
    for (k, widths), split in zip(log_prob_products(dims), log_prob_splits(dims)):
        col_tiles = [cdiv(n, TILE_COLS) for n in widths] + [0] * (2 - len(widths))
        nk = cdiv(k, TILE_K)
        tiles = row_tiles * sum(col_tiles)
        products.append({"K": k, "chunks": nk, "col_tiles": col_tiles, "tiles": tiles,
                         "split": split,
                         "ranges": [(q * nk // split, (q + 1) * nk // split) for q in range(split)]})
    blocks = max(1, min(capacity, max(p["tiles"] * p["split"] for p in products)))
    width = round4(max(i, h, h2, l6, out, h4))
    hmax = round4(max(c1, c2, c3))
    ldx = round4(i)
    part_floats = 0
    for p in products:
        p["local"] = p["split"] > 1 and p["tiles"] >= blocks
        p["items"] = p["tiles"] if p["local"] else p["tiles"] * p["split"]
        if p["split"] > 1:
            part_floats = max(part_floats, (blocks if p["local"] else p["items"]) * TILE_ROWS * TILE_COLS)
    floats = {"A": 0, "B": nrows * width, "H": 2 * nrows * width}
    floats["X"] = floats["H"] + nrows * hmax
    floats["part"] = round4(floats["X"] + nrows * ldx)
    floats["total"] = floats["part"] + part_floats
    # work item i goes to block i * 37 mod blocks (csrc/fused_mlp.cu, plan_apply)
    deal = pow(37, -1, blocks) if blocks % 37 else 1
    head = [row_tiles, blocks, deal, width, hmax, ldx, floats["A"], floats["B"], floats["H"],
            floats["X"], floats["part"]]
    array = head + [v for p in products for v in (p["K"], *p["col_tiles"], p["split"],
                                                   int(p["local"]))]
    return {"rows": nrows, "row_tiles": row_tiles, "blocks": blocks, "deal": deal,
            "capacity": capacity, "sms": sms, "blocks_per_sm": per_sm, "products": products,
            "max_items": max(p["items"] for p in products), "floats": floats, "array": array}


def log_prob_capacity() -> tuple:
    """(SMs, blocks an SM holds, shared bytes a block) of ``fused_log_prob_kernel``
    on the current card, asked once per process."""
    global _capacity
    lib = LIBRARY.get()
    if _capacity is None:
        sms, per_sm, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        err = lib.linna_log_prob_capacity(ctypes.byref(sms), ctypes.byref(per_sm),
                                          ctypes.byref(smem))
        LIBRARY.check(err, "fused_log_prob kernel launch")
        _capacity = (sms.value, per_sm.value, smem.value)
    return _capacity


# the fewest walkers a cluster of the cluster design must take at a width
# for it to run there (log_prob_design)
CLUSTER_WALKERS = 16


def log_prob_design(cluster_walkers: int) -> str:
    """The design of ``fused_log_prob`` at a model's widths, from the most
    walkers a cluster of 8 blocks holds there (``cluster_walkers``: the
    card's shared memory a block over the activations of a walker, a
    function of the widths alone; :func:`cluster_walkers`).

    ``"cluster"`` where a cluster holds ``CLUSTER_WALKERS`` or more: its
    8-block clusters keep the activations on chip and a 128-row launch is
    one wave (the DES width, 27 -> 457: 24 walkers a cluster; faster than
    the tiled design there at 128 rows, PERF.md).  ``"tiled"`` elsewhere:
    one cooperative launch of 64 x 64 tensor-core tiles that reads each
    weight once per row tile (the LSST width, 40 -> 1560: 8 walkers a
    cluster, 16 clusters at 128 rows where the card holds 15).  Never a
    function of the rows, so a row's value does not depend on the rows
    launched beside it."""
    return "cluster" if cluster_walkers >= CLUSTER_WALKERS else "tiled"


def cluster_walkers(dims: Sequence[int]) -> int:
    """The most walkers a cluster of the cluster design takes at the
    kernel's widths ``dims`` on the current card (0 where not one row group
    of 8 fits)."""
    n = LIBRARY.get().linna_cluster_walkers((ctypes.c_int * 10)(*dims))
    if n < 0:
        LIBRARY.check(-n, "fused_log_prob kernel launch")
    return n


def launch_shape(spec: N.ModelSpec, nrows: int, kernel: str) -> Dict[str, int]:
    """The launch shape of ``kernel`` over ``nrows`` walkers (its occupancy
    record).  ``fused_apply`` and the tiled design of ``fused_log_prob``
    are one cooperative launch: the output tile (rows, columns, k per
    stage), blocks, threads, blocks per SM, the card's SMs, each product's k
    split over blocks, the most work items (tiles x split) of any product,
    and dynamic shared memory per block; ``fused_apply`` adds its ring's
    stages, the tiled design which products sum their parts in one block
    (``local``) and the blocks the card holds at once (``capacity``).  The
    cluster design of ``fused_log_prob``: walkers per cluster, the walkers
    per cluster its k split is planned for, blocks per cluster, clusters,
    blocks, threads, shared memory, and the most clusters of that shape the
    card holds at once.  ``fused_log_prob``'s record names its ``design``
    (:func:`log_prob_design`) and its CUDA ``kernel``."""
    lib = LIBRARY.get()
    if kernel == "fused_log_prob":
        dims = kernel_dims(spec)
        design = log_prob_design(cluster_walkers(dims))
        if design == "cluster":
            shape, smem = (ctypes.c_int * 6)(), ctypes.c_longlong()
            LIBRARY.check(lib.linna_cluster_launch_shape(
                nrows, (ctypes.c_int * 10)(*dims), shape, ctypes.byref(smem)),
                "fused_log_prob launch-shape query kernel launch")
            walkers, cluster, blocks, threads, max_clusters, split_walkers = shape
            return {"design": design, "kernel": "fused_log_prob_cluster_kernel",
                    "walkers_per_cluster": walkers, "split_walkers": split_walkers,
                    "cluster_size": cluster, "clusters": blocks // cluster, "blocks": blocks,
                    "threads_per_block": threads, "smem_bytes": smem.value,
                    "max_active_clusters": max_clusters}
        sms, per_sm, smem = log_prob_capacity()
        plan = log_prob_plan(dims, nrows, sms, per_sm)
        return {"design": design, "kernel": "fused_log_prob_kernel",
                "tile": [TILE_ROWS, TILE_COLS, TILE_K], "blocks": plan["blocks"],
                "threads_per_block": TILE_THREADS, "blocks_per_sm": per_sm, "sms": sms,
                "capacity": plan["capacity"], "split": [p["split"] for p in plan["products"]],
                "local": [int(p["local"]) for p in plan["products"]],
                "max_items": plan["max_items"], "smem_bytes": smem}
    dims = (ctypes.c_int * 10)(*kernel_dims(spec))
    shape, smem = (ctypes.c_int * 19)(), ctypes.c_longlong()
    LIBRARY.check(lib.linna_apply_launch_shape(nrows, dims, shape, ctypes.byref(smem)),
                  "fused_apply launch-shape query kernel launch")
    tile_rows, tile_cols, blocks, threads, per_sm, sms, tile_k, stages, items = shape[:9]
    return {"tile": [tile_rows, tile_cols, tile_k], "stages": stages, "blocks": blocks,
            "threads_per_block": threads, "blocks_per_sm": per_sm, "sms": sms,
            "split": list(shape[9:]), "max_items": items, "smem_bytes": smem.value}


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
    plain_shapes["fused_apply"].add((x.shape[0], spec.in_size, spec.out_size))
    return _trunk_plain(x.to(torch.float32), flatten_params(params))


def _launch_apply(spec: N.ModelSpec, x: torch.Tensor, weights) -> torch.Tensor:
    lib = LIBRARY.get()
    dims = (ctypes.c_int * 10)(*check_weights(spec, weights, x.device))
    require(x, "x", torch.float32, (x.shape[0], spec.in_size), x.device)
    out = torch.empty((x.shape[0], spec.out_size), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # the activations between the kernel's products and the partial
        # tiles of the products it splits over blocks
        floats = lib.linna_apply_scratch_floats(x.shape[0], dims)
        if floats < 0:
            LIBRARY.check(-floats, "fused_apply kernel launch")
        scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.linna_fused_apply(
            x.data_ptr(), x.shape[0], pointers(weights), dims, out.data_ptr(),
            scratch.data_ptr(), floats, stream,
        )
    LIBRARY.check(err, "fused_apply kernel launch")
    launches["fused_apply"] += 1
    launch_shapes["fused_apply"].add((x.shape[0], spec.in_size, spec.out_size))
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
    return _FusedApply.apply(spec, x, *flatten_params(params))


# ------------------------------------------------------- fused likelihood


def like_tensors(env) -> List[torch.Tensor]:
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
    plain_shapes["fused_log_prob"].add((x.shape[0], spec.in_size, spec.out_size))
    is_gauss, a1, a2, xm, xs, xl, ym, ys, sg, data, ic, temp = like_tensors(env)
    xw = x.to(torch.float32)
    u = 0.5 * (1.0 + torch.special.erf(xw / 1.4142135623730951))
    x_phys = torch.where(is_gauss, xw * a2 + a1, u * (a2 - a1) + a1)
    bad = torch.any(xl & (x_phys <= 0.0), dim=-1)
    x_in = torch.where(xl, torch.log10(torch.clamp(x_phys, min=1e-30)), x_phys)
    pred = _trunk_plain((x_in - xm) / xs, flatten_params(env["params"]))
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
        self.plans: Dict[int, tuple] = {}
        self.design: Optional[str] = None

    def get(self, env):
        weights = flatten_params(env["params"])
        like = like_tensors(env)
        key = tuple(id(t) for t in weights) + tuple(id(t) for t in like)
        if key != self.key:
            device = env["data"].device
            dims = check_weights(self.spec, weights, device)
            d, n = self.spec.in_size, self.spec.out_size
            names = ("is_gauss", "arg1", "arg2", "x_mean", "x_std", "log10_mask",
                     "y_mean", "y_std", "sigma", "data", "inv_cov", "temperature")
            shapes = [(d,)] * 6 + [(n,)] * 4 + [(n, n), ()]
            dtypes = [torch.bool] + [torch.float32] * 4 + [torch.bool] + [torch.float32] * 6
            for t, name, shape, dt in zip(like, names, shapes, dtypes):
                require(t, name, dt, shape, device)
            self.tensors = weights + like  # keeps the pointed-to tensors alive
            self.device = device
            self.arrays = (pointers(weights), (ctypes.c_int * 10)(*dims), pointers(like))
            self.key = key
        return self.arrays

    def design_of(self) -> str:
        """The model's design (:func:`log_prob_design`), asked once."""
        if self.design is None:
            self.design = log_prob_design(cluster_walkers(kernel_dims(self.spec)))
        return self.design

    def plan(self, nrows: int):
        """(scratch floats, the plan as a ctypes array) of a launch over
        ``nrows`` rows, planned once per row count."""
        got = self.plans.get(nrows)
        if got is None:
            sms, per_sm, _ = log_prob_capacity()
            plan = log_prob_plan(kernel_dims(self.spec), nrows, sms, per_sm)
            got = (plan["floats"]["total"], (ctypes.c_longlong * PLAN_LENGTH)(*plan["array"]))
            self.plans[nrows] = got
        return got


def _launch_log_prob(spec: N.ModelSpec, x: torch.Tensor, env, ypositive: bool,
                     args: _LaunchArgs) -> torch.Tensor:
    lib = LIBRARY.get()
    weights, dims, like = args.get(env)
    require(x, "x", torch.float32, (x.shape[0], spec.in_size), args.device)
    lp = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    design = args.design_of()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == "cluster":
            err = lib.linna_fused_log_prob_cluster(
                x.data_ptr(), x.shape[0], weights, dims, like, int(bool(ypositive)),
                lp.data_ptr(), stream,
            )
        elif x.shape[0] > 0:
            floats, plan = args.plan(x.shape[0])
            # the activations and the split products' partial tiles
            scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
            err = lib.linna_fused_log_prob(
                x.data_ptr(), x.shape[0], weights, dims, like, int(bool(ypositive)), plan,
                scratch.data_ptr(), floats, lp.data_ptr(), stream,
            )
        else:
            err = 0
    LIBRARY.check(err, "fused_log_prob kernel launch")
    launches["fused_log_prob"] += 1
    designs[design] += 1
    launch_shapes["fused_log_prob"].add((x.shape[0], spec.in_size, spec.out_size))
    return lp


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of an env (dicts and named tuples), in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_tensors(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def _tree_rebuild(tree, leaves):
    """``tree`` with its tensor leaves replaced, in :func:`tree_tensors` order."""
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
            leaves = tree_tensors(env)
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
