"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers."""

from . import adamw, fused, graph_loops
from .fused import fused_apply, fused_log_prob  # noqa: F401

# every kernel library of the package, in the order a warm-up builds them
LIBRARIES = (fused.LIBRARY, adamw.LIBRARY, graph_loops.LIBRARY)
