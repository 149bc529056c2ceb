"""Emulator networks as plain functions on a parameter dict of tensors.

Counterpart of ``linna_tpu/nn.py``: the ChtoModelv2 family with the same
parameter keys and ``(in, out)`` weight layout, so a JAX parameter tree
carried across with :func:`params_from_numpy` computes the same numbers.

Topology: input linear -> three width-halving residual blocks with narrow
inner channels -> two ReLU linears -> output linear.  Xavier-uniform
weights everywhere (residual skips included) and all biases 1e-2.

Variants:
- ``chto_v2``        channels (16, 32, 64)
- ``chto_simple``    channels (4, 8, 16)
- ``chto_v2_linear`` v2 plus a ``1e-3 * Linear(in, out)`` bypass
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = [
    "ModelSpec",
    "make_model_spec",
    "hidden_size_for",
    "init_model",
    "apply_model",
    "params_from_numpy",
    "count_params",
    "compute_dtype",
    "MODEL_NAMES",
]

MODEL_NAMES = ("chto_v2", "chto_simple", "chto_v2_linear")

Params = Dict[str, Any]


class ModelSpec(NamedTuple):
    """Static description of an emulator network."""

    name: str
    in_size: int
    out_size: int
    hidden: int
    channel: int
    linear_bypass: bool

    @property
    def widths(self):
        """(h, h/2, h/4, h/8) trunk widths."""
        h = self.hidden
        return (h, h // 2, h // 4, h // 8)


def hidden_size_for(out_size: int) -> int:
    """Width rule: ``max(32, 32*out)``, 1000 for out > 30."""
    if out_size > 30:
        return 1000
    return max(32, int(out_size * 32))


def make_model_spec(name: str, in_size: int, out_size: int) -> ModelSpec:
    if name == "chto_v2":
        return ModelSpec(name, in_size, out_size, hidden_size_for(out_size), 16, False)
    if name == "chto_simple":
        return ModelSpec(name, in_size, out_size, hidden_size_for(out_size), 4, False)
    if name == "chto_v2_linear":
        return ModelSpec(name, in_size, out_size, hidden_size_for(out_size), 16, True)
    raise ValueError(f"unknown model {name!r}; options: {MODEL_NAMES}")


def _xavier_uniform(g: torch.Generator, fan_in: int, fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand((fan_in, fan_out), generator=g) * 2.0 - 1.0) * limit


def _init_linear(g: torch.Generator, fan_in: int, fan_out: int) -> Params:
    return {
        "w": _xavier_uniform(g, fan_in, fan_out),
        "b": torch.full((fan_out,), 1e-2),
    }


def _init_resblock(g: torch.Generator, in_size: int, channel: int, out_size: int) -> Params:
    return {
        "lin1": _init_linear(g, in_size, channel),
        "lin2": _init_linear(g, channel, out_size),
        "skip_w": _xavier_uniform(g, in_size, out_size),
    }


def init_model(spec: ModelSpec, seed: int = 0, device: DeviceLike = None) -> Params:
    """Initialize parameters for ``spec`` from a CPU ``torch.Generator``
    seeded with ``seed`` (the same weights on every device)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    h, h2, h4, h8 = spec.widths
    c = spec.channel
    l6 = h8 * 4 if spec.name != "chto_simple" else h8
    params: Params = {
        "layer1": _init_linear(g, spec.in_size, h),
        "rb1": _init_resblock(g, h, c, h2),
        "rb2": _init_resblock(g, h2, 2 * c, h4),
        "rb3": _init_resblock(g, h4, 4 * c, h8),
        "layer6": _init_linear(g, h8, l6),
        "layer7": _init_linear(g, l6, spec.out_size),
        "layer8": _init_linear(g, spec.out_size, spec.out_size),
    }
    if spec.linear_bypass:
        # zero bias and 1e-5 weights, applied scaled by 1e-3
        params["linear_bypass"] = {
            "w": torch.full((spec.in_size, spec.out_size), 1e-5),
            "b": torch.zeros((spec.out_size,)),
        }
    return _map(params, lambda t: t.to(device))


def _map(tree: Params, fn: Callable) -> Params:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_numpy(tree: Params, device: DeviceLike = None) -> Params:
    """Carry a parameter dict of arrays across (for example the JAX
    package's params after ``jax.device_get``) as float32 tensors."""
    device = resolve_device(device)
    return _map(
        tree, lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    )


def compute_dtype(name, key: str = "compute_dtype") -> Optional[torch.dtype]:
    """A forward's compute type by name (``"bfloat16"``) or as a torch
    dtype; None computes in float32 throughout.  ``key`` names the setting
    in the error."""
    if name is None:
        return None
    dt = name if isinstance(name, torch.dtype) else getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"{key}={name!r} is not a floating-point type")
    return dt


def _affine(c: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``c + x @ w`` rounded once to the weights' type: the product
    accumulates in float32 and ``c`` is added to it before the rounding,
    the JAX package's ``dot(..., preferred_element_type=float32) + c`` then
    ``astype(w.dtype)``.  ``w`` is (in, out) with ``x`` (..., in), or K
    stacked members (K, in, out) with ``x`` (K, B, in) or (B, in)."""
    if w.dim() == 3:
        return torch.baddbmm(c, x.expand(w.shape[0], *x.shape[-2:]), w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    c2 = c if c.dim() == 1 else c.reshape(-1, c.shape[-1])
    return torch.addmm(c2, x2, w).reshape(*lead, w.shape[-1])


def _scaled(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t * c`` with ``c`` rounded to ``t``'s type first, as JAX rounds a
    Python constant multiplying a bfloat16 array (0.1 is 0.10009765625 in
    bfloat16)."""
    return t * float(torch.tensor(c, dtype=t.dtype))


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "b" in p:
        return _affine(p["b"], x, p["w"])
    return x @ p["w"]


def _resblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = relu(0.1 * lin2(relu(lin1(x))) + skip(x)), the skip product added
    before its rounding as in the JAX package."""
    h = torch.relu(_linear(p["lin1"], x))
    return torch.relu(_affine(_scaled(_linear(p["lin2"], h), 0.1), x, p["skip_w"]))


def apply_model(
    spec: ModelSpec,
    params: Params,
    x: torch.Tensor,
    linearmodel: Optional[Callable] = None,
) -> torch.Tensor:
    """Forward pass, batched over leading axes.  ``linearmodel`` is an
    optional pre-model added to the output; ``chto_v2_linear`` ignores it
    and applies only its 1e-3 bypass."""
    s = torch.relu(_linear(params["layer1"], x))
    s = _resblock(params["rb1"], s)
    s = _resblock(params["rb2"], s)
    s = _resblock(params["rb3"], s)
    s = torch.relu(_linear(params["layer6"], s))
    s = torch.relu(_linear(params["layer7"], s))
    out = _linear(params["layer8"], s)
    if spec.linear_bypass:
        out = out + _scaled(_linear(params["linear_bypass"], x), 1e-3)
    elif linearmodel is not None:
        out = out + linearmodel(x)
    return out


def count_params(params: Params) -> int:
    n = 0
    for v in params.values():
        n += count_params(v) if isinstance(v, dict) else v.numel()
    return n
