"""Config/logging/metrics helpers (reference linna/nnutils.py:17-170:
``Params``, ``RunningAverage``, ``set_logger``, ``save_dict_to_json``)."""

from __future__ import annotations

import json
import logging

__all__ = ["Params", "RunningAverage", "set_logger", "save_dict_to_json"]


class Params:
    """JSON-backed hyperparameter bag (reference linna/nnutils.py:17-45)."""

    def __init__(self, json_path: str):
        with open(json_path) as f:
            self.__dict__.update(json.load(f))

    def save(self, json_path: str) -> None:
        with open(json_path, "w") as f:
            json.dump(self.__dict__, f, indent=4)

    def update(self, json_path: str) -> None:
        with open(json_path) as f:
            self.__dict__.update(json.load(f))

    @property
    def dict(self):
        return self.__dict__


class RunningAverage:
    """Streaming mean (reference linna/nnutils.py:48-68)."""

    def __init__(self):
        self.steps = 0
        self.total = 0.0

    def update(self, val: float) -> None:
        self.total += val
        self.steps += 1

    def __call__(self) -> float:
        return self.total / float(self.steps)


def set_logger(log_path: str) -> None:
    """File + console INFO logging (reference linna/nnutils.py:71-94)."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(log_path)
        fh.setFormatter(logging.Formatter("%(asctime)s:%(levelname)s: %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)


def save_dict_to_json(d: dict, json_path: str) -> None:
    """Float-cast and dump (reference linna/nnutils.py:97-107)."""
    with open(json_path, "w") as f:
        json.dump({k: float(v) for k, v in d.items()}, f, indent=4)
