"""Build and load the host C++ components (the ring bus and the join
scheduler) on demand, as ``fmda_tpu.stream._native`` does, shared by both
ctypes bindings.

The sources are the repository's ``native/ringbus.cpp`` and
``native/joincore.cpp``, compiled with ``native/Makefile``'s flags
(``g++ -O2 -std=c++17 -fPIC -shared``) into
``build/fmda_tpu_torch/native/<hash of the source and flags>/``; ``native/``
itself is only read.  Each build writes a temporary name and renames it
into place, so concurrent processes (test workers) can build at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Type

_REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
BUILD_ROOT = _REPO / "build" / "fmda_tpu_torch" / "native"
#: ``native/Makefile``'s CXXFLAGS and link flag
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(lib_name: str) -> Path:
    """Where ``lib<name>.so`` is built: keyed by its source and the flags,
    so an edited source builds anew."""
    source = NATIVE_DIR / (lib_name[len("lib"):-len(".so")] + ".cpp")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(source.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / lib_name


def _build(lib_name: str, lib: Path, exc_cls: Type[Exception]) -> None:
    source = NATIVE_DIR / (lib_name[len("lib"):-len(".so")] + ".cpp")
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as e:
        detail = ""
        if isinstance(e, subprocess.CalledProcessError):
            detail = f": {e.stderr.decode(errors='replace')[-500:]}"
        raise exc_cls(f"cannot build {lib_name} ({e}){detail}") from e
    finally:
        if tmp.exists():
            tmp.unlink()


def build_and_load(lib_name: str, exc_cls: Type[Exception]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib_name`` (``libringbus.so`` or
    ``libjoincore.so``); cached.  Raises ``exc_cls`` with the compiler's
    stderr tail when the toolchain is missing or the build fails."""
    if lib_name in _loaded:
        return _loaded[lib_name]
    try:
        lib_path = library_path(lib_name)
    except OSError as e:  # a checkout without native/
        raise exc_cls(f"cannot read the source of {lib_name} ({e})") from e
    if not lib_path.exists():
        _build(lib_name, lib_path, exc_cls)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:  # a stale or foreign .so
        raise exc_cls(f"cannot load {lib_path}: {e}") from e
    _loaded[lib_name] = lib
    return lib
