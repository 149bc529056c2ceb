"""YAML configuration with ``include:`` merging.

Counterpart of ``linna_tpu/config.py``: an ``include:`` key pulls in base
files from the yaml directory, the including file's keys taking precedence
(the contract of the reference's ``chto_yamlload`` as its exemplar configs
use it).
"""

from __future__ import annotations

import os
from typing import Optional

import yaml

__all__ = ["yaml_load"]


def yaml_load(path: str, parent_dir: Optional[str] = None) -> dict:
    """Load ``path``; if the mapping has ``include: <file>`` (or a list of
    files), recursively load those (resolved against ``parent_dir``, default
    the including file's directory) and merge, later/outer keys overriding."""
    with open(path) as f:
        params = yaml.safe_load(f) or {}
    if not isinstance(params, dict):
        raise TypeError(f"{path} must contain a YAML mapping, got {type(params)}")
    base_dir = parent_dir if parent_dir is not None else os.path.dirname(path)
    includes = params.pop("include", None)
    if includes is None:
        return params
    if isinstance(includes, str):
        includes = [includes]
    merged: dict = {}
    for inc in includes:
        inc_path = inc if os.path.isabs(inc) else os.path.join(base_dir, inc)
        merged.update(yaml_load(inc_path, parent_dir=parent_dir))
    merged.update(params)
    return merged
