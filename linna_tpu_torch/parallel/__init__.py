"""Ensemble training: K emulator members stacked on one device."""

from .ensemble import EnsembleTrainer  # noqa: F401
