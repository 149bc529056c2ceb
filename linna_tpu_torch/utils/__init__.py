"""Utilities: pickle-free checkpointing."""

from . import checkpoint  # noqa: F401
