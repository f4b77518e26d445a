"""Plain references, one module per configuration file's ``reference``.
They import nothing of the program under test."""

import importlib
from types import ModuleType


def load(name: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{name}")
