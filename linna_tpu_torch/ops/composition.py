"""The K-member composition's value and input gradient as one CUDA kernel.

The gradient samplers (HMC, NUTS, their step-size search, the MAP search's
BFGS) ask :func:`linna_tpu_torch.likelihood.make_log_prob`'s composition for
a value and its gradient at every leapfrog.  Under PyTorch's autograd that
is about 30 small f32 cuBLAS products and 60 elementwise launches a call at
NUTS's 256 walkers.  ``composition_grad_kernel`` (``csrc/fused_mlp.cu``)
computes both in one cooperative launch of the tiled 3xTF32 products that
``fused_log_prob`` runs, with a member axis and the backward's products
over transposed weights (the kernel's comment says what bounds it).

From the standardized input ``x_in`` (W, D), which the K stacked members
share, it returns the tempered log-likelihood (W,), ``-0.5 (mean_k chi2_k
+ k_std std_k chi2_k) / T`` (``-0.5 chi2 / T`` for one member), and its
gradient with respect to ``x_in`` (W, D).  :class:`GradRoute` is one
likelihood's side of it: copies of the env's weights and their transposes,
made once at the first call (a CUDA graph captured since holds their
addresses, so a later change to the env raises), and a plan by row count.
The prior transform, the x transform, the log-prior and the NaN rule stay
PyTorch around it, so autograd carries the gradient through them
(:class:`_CompositionGrad`).

The launch is planned here, on the host, by :func:`plan`: a pure function
of the widths, the members and the rows (and of what the card holds at
once), whose k split of every product follows the widths and the members
alone, so a row's value and gradient do not depend on the rows launched
beside it.  For a CPU tensor :meth:`GradRoute.value_and_grad` runs the
plain version: autograd of the composition's chi^2, weighed by the
kernel's combining pass (:func:`combine`).  Both count themselves under
``composition_grad`` in :mod:`linna_tpu_torch.ops.library`'s counters.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import nn as N
from . import fused as F
from .library import launches, plain_calls, require

__all__ = ["GradRoute", "combine", "engages", "func_transform_active", "supports", "plan",
           "products", "operations", "buffer_widths", "capacity", "MAX_MEMBERS", "PLAN_LENGTH"]

# csrc/fused_mlp.cu: the scratch buffers (GradBuf), the plan's head and
# per-product values, the most members a launch takes
BUFFERS = ("S1", "H1", "S2", "H2", "S3", "H3", "S4", "S6", "S7", "delta", "R1", "R2",
           "GY", "G7", "G6", "G4", "GS3", "GH3", "GS2", "GH2", "GS1", "GH1")
PRODUCTS = 21
PLAN_HEAD = 5 + len(BUFFERS)
PLAN_PRODUCT = 6
PLAN_LENGTH = PLAN_HEAD + PLAN_PRODUCT * PRODUCTS
MAX_MEMBERS = 32
# each product's k split is planned for this many row tiles: 256 rows, the
# gradient samplers' ensemble (faster on the card than 1, 2 or 8, PERF.md)
SPLIT_ROW_TILES = 4
# composition_grad_kernel on this card: (SMs, blocks an SM holds, shared bytes a block)
_capacity: Optional[tuple] = None


def buffer_widths(dims: Sequence[int]) -> List[int]:
    """The width of each scratch buffer (``BUFFERS``) on the kernel's widths
    (``fused.kernel_dims``)."""
    i, h, h2, h4, h8, c1, c2, c3, l6, out = dims
    return [h, c1, h2, c2, h4, c3, h8, l6, out, out, out, out,
            out, out, l6, h8, h4, c3, h2, c2, h, c1]


def products(dims: Sequence[int], members: int) -> List[tuple]:
    """The kernel's 21 products: (K, the output widths of its segments, the
    members it runs for).  The forward: layer 1, the residual blocks' lin1
    | skip and lin2, layers 6, 7 and 8, delta @ [C | C^T]; the backward:
    layers 8, 7 and 6 transposed, each residual block's [skip^T | lin2^T]
    and lin1^T, and layer 1^T over the members' gradients side by side."""
    i, h, h2, h4, h8, c1, c2, c3, l6, out = dims
    fwd = [(i, (h,)), (h, (c1, h2)), (c1, (h2,)), (h2, (c2, h4)), (c2, (h4,)),
           (h4, (c3, h8)), (c3, (h8,)), (h8, (l6,)), (l6, (out,)), (out, (out,)),
           (out, (out, out))]
    bwd = [(out, (out,)), (out, (l6,)), (l6, (h8,)), (h8, (h4, c3)), (c3, (h4,)),
           (h4, (h2, c2)), (c2, (h2,)), (h2, (h, c1)), (c1, (h,))]
    return [(k, w, members) for k, w in fwd + bwd] + [(members * h, (i,), 1)]


def operations(dims: Sequence[int], members: int, nrows: int) -> float:
    """The kernel's floating-point operations over ``nrows`` rows: two for
    each multiply-add of its products (:func:`products`), 5.86 M a row and
    member at the DES width (27 -> 457)."""
    return 2.0 * nrows * sum(k * sum(w) * m for k, w, m in products(dims, members))


def supports(dims: Sequence[int], members: int) -> bool:
    """Whether the kernel takes ``members`` members of these widths: at most
    ``MAX_MEMBERS``, and a hidden width whose rows of layer 1 stay 16-byte
    aligned side by side (every ``chto`` width is a multiple of 32)."""
    return 1 <= members <= MAX_MEMBERS and dims[1] % 4 == 0


def plan(dims: Sequence[int], members: int, nrows: int, sms: int = F.H100[0],
         per_sm: int = F.H100[1]) -> dict:
    """The launch of ``composition_grad_kernel`` over ``nrows`` rows of
    ``members`` members on a card of ``sms`` SMs that hold ``per_sm``
    blocks each.

    Every product's tiles (64 x 64, ``row_tiles`` down the rows, its
    segments' column tiles across, for each member) and k split
    (:func:`linna_tpu_torch.ops.fused.k_split` at ``SPLIT_ROW_TILES`` row
    tiles: the widths and the members alone).  The grid is as many blocks
    as the product with the most work items has, at most all that the card
    holds at once; a split product whose tiles fill the grid is ``local``,
    as in :func:`linna_tpu_torch.ops.fused.log_prob_plan`.  ``floats``: each
    buffer's offset in the scratch, the partial tiles' and the total;
    ``array`` the plan as the kernel takes it."""
    dims = [int(v) for v in dims]
    members, nrows = int(members), int(nrows)
    if not supports(dims, members):
        raise ValueError(f"composition_grad takes 1 to {MAX_MEMBERS} members and a hidden "
                         f"width that is a multiple of 4, not {members} members of {dims}")
    tile = F.TILE_ROWS * F.TILE_COLS
    row_tiles = F.cdiv(nrows, F.TILE_ROWS)
    prods = []
    for k, widths, m in products(dims, members):
        col_tiles = [F.cdiv(n, F.TILE_COLS) for n in widths] + [0] * (2 - len(widths))
        nk = F.cdiv(k, F.TILE_K)
        split = F.k_split(k, widths, SPLIT_ROW_TILES, m)
        prods.append({"K": k, "chunks": nk, "col_tiles": col_tiles, "members": m,
                      "tiles": row_tiles * sum(col_tiles) * m, "split": split,
                      "ranges": [(q * nk // split, (q + 1) * nk // split) for q in range(split)]})
    capacity_ = sms * per_sm
    blocks = max(1, min(capacity_, max(p["tiles"] * p["split"] for p in prods)))
    part_floats = 0
    for p in prods:
        p["local"] = p["split"] > 1 and p["tiles"] >= blocks
        p["items"] = p["tiles"] if p["local"] else p["tiles"] * p["split"]
        if p["split"] > 1:
            part_floats = max(part_floats, (blocks if p["local"] else p["items"]) * tile)
    floats, end = {}, 0
    for name, width in zip(BUFFERS, buffer_widths(dims)):
        ms = width if name in ("S1", "GS1") else F.round4(width)
        floats[name] = end
        end = F.round4(end + nrows * members * ms)
    floats["part"] = end
    floats["total"] = end + part_floats
    deal = pow(37, -1, blocks) if blocks % 37 else 1
    head = [row_tiles, blocks, deal, members] + [floats[b] for b in BUFFERS] + [floats["part"]]
    array = head + [v for p in prods for v in (p["K"], *p["col_tiles"], p["members"],
                                                p["split"], int(p["local"]))]
    return {"rows": nrows, "members": members, "row_tiles": row_tiles, "blocks": blocks,
            "deal": deal, "capacity": capacity_, "sms": sms, "blocks_per_sm": per_sm,
            "products": prods, "max_items": max(p["items"] for p in prods),
            "floats": floats, "array": array}


def capacity() -> tuple:
    """(SMs, blocks an SM holds, shared bytes a block) of
    ``composition_grad_kernel`` on the current card, asked once per process."""
    global _capacity
    lib = F.LIBRARY.get()
    if _capacity is None:
        if lib.linna_composition_grad_plan_length() != PLAN_LENGTH:
            raise RuntimeError("csrc/fused_mlp.cu's composition_grad plan length is "
                               f"{lib.linna_composition_grad_plan_length()}, this module's "
                               f"{PLAN_LENGTH}")
        sms, per_sm, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        err = lib.linna_composition_grad_capacity(ctypes.byref(sms), ctypes.byref(per_sm),
                                                  ctypes.byref(smem))
        F.LIBRARY.check(err, "composition_grad kernel launch")
        _capacity = (sms.value, per_sm.value, smem.value)
    return _capacity


# ------------------------------------------------------------ the route


def func_transform_active() -> bool:
    """Whether a ``torch.func`` transform (grad, vmap, jacfwd, hessian) is
    tracing the current call: PyTorch's functorch interpreter stack is not
    empty.  The route's one private PyTorch call, kept here so that its
    test fails if the API moves."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def engages(x_in: torch.Tensor, leaves: Sequence[torch.Tensor]) -> bool:
    """Whether a call of the composition at ``x_in`` takes the kernel: the
    tensor is on a card, autograd records it (grad mode on and ``x_in``
    requires a gradient), no tensor of the env (``leaves``) requires one,
    and no ``torch.func`` transform is tracing the call (the
    ``autograd.Function`` has no forward-mode or vmap rule)."""
    return (x_in.is_cuda and torch.is_grad_enabled() and x_in.requires_grad
            and not func_transform_active() and not any(t.requires_grad for t in leaves))


def combine(chi2: torch.Tensor, k_std: torch.Tensor,
            temperature: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's combining pass: from the members' chi^2 (K, W), the
    tempered log-likelihood (W,) and each member's weight d lp / d chi2_k
    (K, W).  Where the members agree (std 0) the std's weight is its
    subgradient 0, where PyTorch's std backward is NaN: the one place the
    kernel departs from autograd of the composition."""
    k = chi2.shape[0]
    if k == 1:
        return -0.5 * chi2[0] / temperature, torch.full_like(chi2, -0.5) / temperature
    mean, sd = chi2.mean(dim=0), chi2.std(dim=0, correction=0)
    lp = -0.5 * (mean + k_std * sd) / temperature
    per_sd = torch.where((sd > 0) & (k_std != 0), k_std / (k * sd), 0.0)
    return lp, (-0.5 / temperature) * (per_sd * (chi2 - mean) + 1.0 / k)


def _stacked(weights: Sequence[torch.Tensor], members: int) -> List[torch.Tensor]:
    """The 23 weights with a member axis: (K, in, out) and biases (K, 1, out)."""
    if members > 1:
        return list(weights)
    return [w[None] if w.dim() == 2 else w[None, None] for w in weights]


def _transposed(w: Sequence[torch.Tensor], inv_cov: torch.Tensor, members: int,
                h: int, d: int) -> List[torch.Tensor]:
    """The backward's weights (csrc/fused_mlp.cu, make_grad_plan): layers 8,
    7 and 6, then rb3, rb2, rb1 (skip, lin2, lin1 each), each (K, out, in);
    layer 1 over the members, (K h, D); C^T."""
    t = lambda a: a.transpose(-1, -2).contiguous()
    out = [t(w[21]), t(w[19]), t(w[17])]
    for i in (2, 1, 0):
        lin1, lin2, skip = w[2 + 5 * i], w[4 + 5 * i], w[6 + 5 * i]
        out += [t(skip), t(lin2), t(lin1)]
    out += [t(w[0]).reshape(members * h, d).contiguous(), t(inv_cov)]
    return out


class _CompositionGrad(torch.autograd.Function):
    """The composition's tempered log-likelihood at ``x_in``, its gradient
    computed beside it and handed back in the backward pass."""

    @staticmethod
    def forward(ctx, x_in, route):
        lp, grad = route.value_and_grad(x_in)
        ctx.save_for_backward(grad)
        return lp

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None] * grad, None


class GradRoute:
    """The kernel's side of one likelihood of ``members`` stacked members
    over ``env`` (:func:`linna_tpu_torch.likelihood.make_log_prob`'s), whose
    composition gives the members' chi^2 (K, W) at ``x_in`` as
    ``chi2(x_in)``."""

    def __init__(self, spec: N.ModelSpec, env: dict, members: int, ypositive: bool,
                 chi2: Callable[[torch.Tensor], torch.Tensor]):
        self.spec, self.env, self.chi2 = spec, env, chi2
        self.members, self.ypositive = int(members), bool(ypositive)
        self.dims = F.kernel_dims(spec)
        self.snapshot = None
        self.plans: Dict[int, Tuple[int, ctypes.Array]] = {}

    def __call__(self, x_in: torch.Tensor) -> torch.Tensor:
        """The tempered log-likelihood (W,) at ``x_in``, differentiable."""
        return _CompositionGrad.apply(x_in, self)

    def engages(self, x_in: torch.Tensor) -> bool:
        return engages(x_in, F.tree_tensors(self.env))

    def _sources(self) -> List[torch.Tensor]:
        """The env's tensors the kernel reads: the 23 weights, the 12 of
        ``fused.like_tensors`` and k_std."""
        env = self.env
        return F.flatten_params(env["params"]) + F.like_tensors(env) + [env["k_std"]]

    def prepare(self):
        """The kernel's inputs as ctypes pointer arrays: checked copies of
        the env's tensors and the transposed weights, made once, at the
        first call.  A CUDA graph captured since holds their addresses, so
        they are never made again: a tensor of the env replaced or written
        in place after that call raises."""
        sources = self._sources()
        if self.snapshot is not None:
            seen, arrays, _ = self.snapshot
            if any(t is not s or t._version != v for t, (s, v) in zip(sources, seen)):
                raise RuntimeError(
                    "composition_grad: a tensor of the likelihood's env was replaced or written "
                    "after its first gradient call on the card; build a new log-prob")
            return arrays
        device = self.env["data"].device
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("composition_grad: the first gradient call on the card copies "
                               "the weights and cannot run under CUDA graph capture")
        k, d, out = self.members, self.spec.in_size, self.spec.out_size
        copies = [t.detach().clone() for t in sources]
        weights, like, k_std = copies[:23], copies[23:35], copies[35]
        F.check_weights(self.spec, weights, device, k)
        names = ("y_mean", "y_std", "sigma", "data", "inv_cov", "temperature")
        shapes = [(out,)] * 4 + [(out, out), ()]
        for t, name, shape in zip(like[6:], names, shapes):
            require(t, name, torch.float32, shape, device)
        require(k_std, "k_std", torch.float32, (), device)
        transposed = _transposed(_stacked(weights, k), like[10], k, self.spec.hidden, d)
        arrays = (F.pointers(weights), F.pointers(transposed), (ctypes.c_int * 10)(*self.dims),
                  F.pointers(like), k_std.data_ptr())
        # the copies stay alive with the pointers to them
        self.snapshot = ([(t, t._version) for t in sources], arrays,
                         (weights, like, k_std, transposed))
        return arrays

    def plan(self, nrows: int):
        """(scratch floats, the plan as a ctypes array) over ``nrows`` rows,
        planned once per row count."""
        got = self.plans.get(nrows)
        if got is None:
            sms, per_sm, _ = capacity()
            p = plan(self.dims, self.members, nrows, sms, per_sm)
            got = (p["floats"]["total"], (ctypes.c_longlong * PLAN_LENGTH)(*p["array"]))
            self.plans[nrows] = got
        return got

    def value_and_grad(self, x_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lp (W,), d lp / d x_in (W, D)): the kernel for a tensor on a
        card, the plain version elsewhere."""
        x_in = x_in.detach()
        if x_in.device.type != "cuda":
            return self.value_and_grad_plain(x_in)
        lib = F.LIBRARY.get()
        weights, transposed, dims, like, k_std = self.prepare()
        x_in = x_in.contiguous()
        n, d = x_in.shape[0], self.spec.in_size
        require(x_in, "x_in", torch.float32, (n, d), self.env["data"].device)
        lp = torch.empty((n,), dtype=torch.float32, device=x_in.device)
        grad = torch.empty((n, d), dtype=torch.float32, device=x_in.device)
        err = 0
        if n > 0:
            floats, array = self.plan(n)
            with torch.cuda.device(x_in.device):
                # every layer's activations and gradients, and the split
                # products' partial tiles
                scratch = torch.empty((floats,), dtype=torch.float32, device=x_in.device)
                stream = torch.cuda.current_stream(x_in.device).cuda_stream
                err = lib.linna_composition_grad(
                    x_in.data_ptr(), n, self.members, weights, transposed, dims, like,
                    int(self.ypositive), k_std, array, scratch.data_ptr(), floats,
                    lp.data_ptr(), grad.data_ptr(), stream)
        F.LIBRARY.check(err, "composition_grad kernel launch")
        launches["composition_grad"] += 1
        return lp, grad

    def value_and_grad_plain(self, x_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Plain version of the kernel: autograd of the composition's chi^2
        (``chi2``, on the env as it is), weighed by :func:`combine`."""
        plain_calls["composition_grad"] += 1
        env = self.env
        with torch.enable_grad():
            x = x_in.detach().to(torch.float32).requires_grad_(True)
            chi2 = self.chi2(x).reshape(self.members, x.shape[0])
            lp, wk = combine(chi2.detach(), env["k_std"], env["temperature"])
            (grad,) = torch.autograd.grad(chi2, x, wk)
        return lp, grad
