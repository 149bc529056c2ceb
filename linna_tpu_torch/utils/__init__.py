"""Utilities: pickle-free checkpointing, metrics/logging, tracing, plots."""

from . import checkpoint, metrics, plots, runtime, trace  # noqa: F401
from .metrics import Params, RunningAverage, save_dict_to_json, set_logger  # noqa: F401
from .trace import PhaseTimer, device_profile  # noqa: F401
