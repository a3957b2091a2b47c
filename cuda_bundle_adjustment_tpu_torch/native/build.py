"""Build ``native/symbolic.cpp`` into a shared library at first use; load it
with ctypes.

The scheme of ``kernels/_build.py``, with ``g++`` in place of ``nvcc``: the
library's file name carries a hash of the source text, the compiler flags,
``g++ --version`` and the host's machine type, so an edited source, another
flag or another compiler never loads a stale build (no ``-march=native``:
a build directory shared by two hosts holds nothing host-specific).  The
compiler writes to a unique temporary name that is renamed onto the final
one only after a successful build; a failed build raises with the
compiler's output and leaves nothing behind.  A module lock guards the
build and the load.  The build directory is ``build/torch_native`` at the
repository root (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "symbolic.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()
_compiler: dict[str, str] = {}


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's symbolic analysis cannot be built")
    return found


def compiler_version() -> str:
    """``g++ --version``'s first line (read once a process)."""
    if "version" not in _compiler:
        out = subprocess.run([_gxx(), "--version"], capture_output=True, text=True, check=True)
        _compiler["version"] = out.stdout.strip().splitlines()[0]
    return _compiler["version"]


def library_path() -> Path:
    """Content-addressed path of the built library for :data:`SOURCE`."""
    key = b"\0".join([
        SOURCE.read_bytes(), "\0".join(FLAGS).encode(),
        compiler_version().encode(), platform.machine().encode(),
    ])
    return BUILD_DIR / f"lib{SOURCE.stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{SOURCE.stem}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_gxx(), *FLAGS, str(SOURCE), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The loaded library for :data:`SOURCE`, building it if needed."""
    with _lock:
        path = library_path()
        lib = _libs.get(path)
        if lib is None:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _libs[path] = lib
        return lib
