"""The trainer's AdamW step as one CUDA kernel.

The JAX package's trainer leaves AdamW to ``optax.adamw`` inside its jitted
step, where XLA fuses it.  Run as PyTorch ops on the card, the same update
of the (K, P) stacked parameters is about twenty elementwise launches, plus
the concatenation of the leaves' gradients and its cast to float32, each a
full pass over device memory.  :func:`adamw_` runs it as one launch of
``csrc/adamw.cu`` that reads each leaf's gradient where autograd left it
and writes the parameters and both moments in place (the kernel's comment
says what bounds it).  For a CPU tensor it runs the plain version,
:func:`adamw_plain_`: the leaves concatenated and the PyTorch ops of
``optax.adamw``, op for op, which the kernel matches bit for bit.

The kernel is a library of its own (:class:`~linna_tpu_torch.ops.library.KernelLibrary`),
so a training run never compiles ``fused_mlp.cu``.  Both versions count
themselves under ``adamw`` in :mod:`linna_tpu_torch.ops.library`'s counters.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .library import KernelLibrary, launches, plain_calls, require

__all__ = ["adamw_", "adamw_plain_", "segment_table", "ADAM_B1", "ADAM_B2", "ADAM_EPS",
           "LIBRARY"]

SOURCE = Path(__file__).parent / "csrc" / "adamw.cu"
# optax's injected hyperparameters are float32, so 1 - b is taken in float32
ADAM_B1, ADAM_B2, ADAM_EPS = np.float32(0.9), np.float32(0.999), np.float32(1e-8)
_ONE = np.float32(1.0)
# the storage types the kernel reads and writes, by its codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# csrc/adamw.cu: the most segments (leaves) a launch takes
MAX_SEGMENTS = 32

Grad = Union[torch.Tensor, Sequence[torch.Tensor]]

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lls = ctypes.POINTER(_ll)
LIBRARY = KernelLibrary(SOURCE, {
    "linna_adamw_step": ([_vp, _vp, _ci, _vp, _ci, _ll, _ci, ctypes.POINTER(_vp), _lls, _lls, _lls,
                          _ci, _vp, _ll, _vp, _ll, _vp, _vp, ctypes.POINTER(ctypes.c_float), _vp],
                         _ci),
}, error="linna_adamw_error_string", abi=("linna_adamw_max_segments", MAX_SEGMENTS))


def segment_table(grads: Sequence[torch.Tensor], k: int) -> List[Tuple[int, int]]:
    """(first element in a member's row, elements a member) of each of the
    K-member gradients ``grads``, in order: the rows' layout the leaves
    tile, as ``train.Layout.entries`` lays them out."""
    table, off = [], 0
    for g in grads:
        n = g.numel() // k
        table.append((off, n))
        off += n
    return table


def _checked(flat: torch.Tensor, grad: Grad, state, lr: torch.Tensor,
             wd: torch.Tensor) -> List[torch.Tensor]:
    """The gradients as a list, once every argument has the type, shape and
    device the update takes (raises otherwise)."""
    if flat.dim() != 2:
        raise ValueError(f"flat: expected (K, P), got shape {tuple(flat.shape)}")
    k, p = flat.shape
    dev = flat.device
    require(flat, "flat", torch.float32, (k, p), dev)
    require(state.mu, "mu", tuple(DTYPES), (k, p), dev)
    require(state.nu, "nu", torch.float32, (k, p), dev)
    require(state.count, "count", torch.int32, (k,), dev)
    require(lr, "lr", torch.float32, (k, 1), dev, contiguous=False)
    require(wd, "wd", torch.float32, (k, 1), dev, contiguous=False)
    grads = [grad] if torch.is_tensor(grad) else list(grad)
    if not grads:
        raise ValueError("no gradient")
    for i, g in enumerate(grads):
        require(g, f"gradient {i}", tuple(DTYPES) if i == 0 else grads[0].dtype,
                   (k, *g.shape[1:]), dev, contiguous=False)
    table = segment_table(grads, k)
    if sum(n for _, n in table) != p or any(g.numel() != k * n for g, (_, n) in
                                           zip(grads, table)):
        raise ValueError(f"the gradients hold {[tuple(g.shape) for g in grads]}, not "
                         f"{p} elements a member")
    return grads


@torch.no_grad()
def adamw_plain_(flat: torch.Tensor, grad: Grad, state, lr: torch.Tensor,
                 wd: torch.Tensor) -> None:
    """Plain PyTorch version of the kernel: the gradients concatenated in
    float32, then ``optax.adamw``'s arithmetic op for op, in place."""
    plain_calls["adamw"] += 1
    k = flat.shape[0]
    grads = [grad] if torch.is_tensor(grad) else list(grad)
    grad = torch.cat([g.reshape(k, -1) for g in grads], dim=1).to(torch.float32)
    state.count.add_(1)
    # no fused multiply-adds: each product rounds on its own, as in optax
    if state.mu.dtype == torch.float32:
        mu = state.mu.mul_(float(ADAM_B1)).add_(float(_ONE - ADAM_B1) * grad)
    else:
        mu = state.mu.to(torch.float32) * float(ADAM_B1) + float(_ONE - ADAM_B1) * grad
        state.mu.copy_(mu)
    state.nu.mul_(float(ADAM_B2)).add_(float(_ONE - ADAM_B2) * (grad * grad))
    bc1, bc2 = _bias_corrections(state)
    mu_hat = mu / bc1
    nu_hat = state.nu / bc2
    update = mu_hat / (torch.sqrt(nu_hat) + float(ADAM_EPS)) + wd * flat
    flat.add_(update * -lr)


def _bias_corrections(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 - b1^count and 1 - b2^count of each member, (K, 1) float32."""
    count = state.count.to(torch.float32)[:, None]
    return 1.0 - torch.pow(float(ADAM_B1), count), 1.0 - torch.pow(float(ADAM_B2), count)


@torch.no_grad()
def adamw_(flat: torch.Tensor, grad: Grad, state, lr: torch.Tensor, wd: torch.Tensor) -> None:
    """One AdamW update of the (K, P) parameters ``flat`` and the
    ``AdamWState`` ``state`` in place.  ``grad``: the (K, P) gradient, or
    the leaves' gradients (each (K, ...), in the row's layout order, one
    type); ``lr`` and ``wd`` (K, 1) float32.  A CUDA tensor launches the
    kernel and raises if the build or the launch fails; a CPU tensor runs
    :func:`adamw_plain_`.  Arguments are checked before either."""
    grads = _checked(flat, grad, state, lr, wd)
    if not flat.is_cuda:
        adamw_plain_(flat, grads, state, lr, wd)
        return
    if len(grads) > MAX_SEGMENTS:
        raise ValueError(f"{len(grads)} gradient leaves; the kernel takes {MAX_SEGMENTS}")
    lib = LIBRARY.get()
    k, p = flat.shape
    rows = []
    for g in grads:
        g = g.reshape(k, -1)  # a view where each member's elements are contiguous
        rows.append(g if g.stride(1) == 1 or g.shape[1] <= 1 else g.contiguous())
    table = segment_table(rows, k)
    n = len(rows)
    state.count.add_(1)
    bc1, bc2 = _bias_corrections(state)
    consts = (ctypes.c_float * 5)(float(ADAM_B1), float(_ONE - ADAM_B1), float(ADAM_B2),
                                  float(_ONE - ADAM_B2), float(ADAM_EPS))
    longs = lambda vals: (ctypes.c_longlong * n)(*vals)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.linna_adamw_step(
            flat.data_ptr(), state.mu.data_ptr(), DTYPES[state.mu.dtype], state.nu.data_ptr(),
            k, p, n, (ctypes.c_void_p * n)(*(g.data_ptr() for g in rows)),
            longs(o for o, _ in table), longs(m for _, m in table),
            longs(g.stride(0) for g in rows), DTYPES[rows[0].dtype],
            lr.data_ptr(), lr.stride(0), wd.data_ptr(), wd.stride(0),
            bc1.data_ptr(), bc2.data_ptr(), consts, stream)
    LIBRARY.check(err, "adamw kernel launch")
    launches["adamw"] += 1
