"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers."""

from .fused import fused_apply, fused_log_prob  # noqa: F401
