"""Result and weight path conventions of the estimator CLIs (a copy of the
JAX package's ``utils/paths.py``)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def parse_path(path: str) -> tuple[str, str]:
    """The '{name}_best' / '{name}_last' sibling directories of ``path``
    (an empty path gives an empty pair). Absolute paths stay absolute."""
    if path == "":
        return "", ""
    head, name = os.path.split(os.path.normpath(path))
    return os.path.join(head, name + "_best"), os.path.join(head, name + "_last")


def save_result(path: str, result: dict, index: int) -> None:
    """Save one fold's estimates as ``estimate{index + 1}.npz``."""
    Path(path).mkdir(parents=True, exist_ok=True)
    np.savez(os.path.join(path, f"estimate{index + 1}.npz"), **result)
