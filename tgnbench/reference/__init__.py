"""Plain-PyTorch references of the model families, one module each, found
by the ``reference`` name in a configuration's file. They import nothing of
the program under test."""
from __future__ import annotations

import importlib

from tgnbench.reference import common

__all__ = ["common", "family"]


def family(name: str):
    """The reference module ``tgnbench/reference/<name>.py``."""
    return importlib.import_module(f"tgnbench.reference.{name}")
