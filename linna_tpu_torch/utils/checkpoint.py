"""Pickle-free parameter checkpoints (PyTorch).

The same layout as ``linna_tpu/utils/checkpoint.py``: one ``.npz`` whose
keys are ``params/<path>`` (and ``opt/<path>``) with ``/``-joined
dictionary keys or list indices, plus a ``__meta__`` entry holding a JSON
blob as uint8 bytes.  Written atomically (tmp + rename).  A checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_exists",
    "read_checkpoint_raw",
    "params_from_raw",
]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        arr = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
        return {prefix: arr}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(arrays: Dict[str, np.ndarray], prefix: str, device) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.as_tensor(arr, device=device)
    return tree


def _check_like(tree: Any, like: Any, path: str = "") -> None:
    """Key-set and shape check against a template, as the JAX package's
    template-driven load does."""
    if isinstance(like, dict):
        for k, v in like.items():
            key = f"{path}/{k}" if path else str(k)
            if k not in tree:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            _check_like(tree[k], v, key)
        return
    if tuple(tree.shape) != tuple(like.shape):
        raise ValueError(
            f"checkpoint leaf {path!r} shape {tuple(tree.shape)} != expected "
            f"{tuple(like.shape)}"
        )


def save_checkpoint(
    path: str,
    params: Any,
    opt_state: Any = None,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``{params, opt_state}`` trees and JSON-able ``meta`` atomically."""
    arrays = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        arrays.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_checkpoint_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The checkpoint's flat arrays and its meta."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode()) if "__meta__" in arrays else {}
    return arrays, meta


def load_checkpoint(
    path: str, params_like: Any = None, device: DeviceLike = None
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], Dict[str, Any]]:
    """Load a checkpoint as nested dicts of tensors on ``device``.

    Returns (params, opt_state_or_None, meta).  With ``params_like`` the
    params must hold every leaf of the template at the template's shape."""
    device = resolve_device(device)
    arrays, meta = read_checkpoint_raw(path)
    params = _unflatten(arrays, "params/", device)
    if params_like is not None:
        _check_like(params, params_like)
    opt = _unflatten(arrays, "opt/", device) if any(k.startswith("opt/") for k in arrays) else None
    return params, opt, meta


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path)


def params_from_raw(
    params_like: Any, arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, Any]:
    """The ``params/`` half of a :func:`read_checkpoint_raw` payload as
    nested dicts of tensors on ``device``, checked against ``params_like``
    (every leaf of the template at its shape; None skips the check): the
    unflatten half of :func:`load_checkpoint`, for a payload read once by
    rank 0 and broadcast."""
    params = _unflatten(arrays, "params/", resolve_device(device))
    if params_like is not None:
        _check_like(params, params_like)
    return params
