"""Lazy package exports (PEP 562) from a name table.

A package's ``__init__`` keeps a table of its public names, each mapped to
the submodule that defines it, and binds what :func:`lazy_exports` returns
as its module-level ``__getattr__`` and ``__dir__``.  A name's submodule is
imported on its first access only, so a process that never touches the
torch-backed exports (the multi-host router, the broker) never imports
torch.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, List, Tuple


def lazy_exports(
    package: str, exports: Dict[str, str],
) -> Tuple[Callable[[str], object], Callable[[], List[str]]]:
    """``(__getattr__, __dir__)`` for ``package`` over ``exports`` (public
    name -> defining submodule).  A resolved name is cached in the
    package's namespace, so its next access skips ``__getattr__``."""
    namespace = vars(sys.modules[package])

    def __getattr__(name: str) -> object:
        module_name = exports.get(name)
        if module_name is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(module_name), name)
        namespace[name] = value
        return value

    def __dir__() -> List[str]:
        return sorted(set(namespace) | set(exports))

    return __getattr__, __dir__
