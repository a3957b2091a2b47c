"""Build ``csrc/<name>.cu`` into a shared library at first use; load it with
ctypes.

Each source compiles on its own with ``nvcc`` into a plain-C-interface
library (no PyTorch headers, so a build takes seconds, not minutes).  The
library's file name carries a hash of the source text and the compiler
flags, so an edited source never loads a stale build.  The compiler writes
to a unique temporary name that is renamed onto the final one only after a
successful build; a failed build raises with the compiler's output and
leaves nothing behind.  The build directory is ``build/torch_kernels`` at
the repository root (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("gather", "terms", "lminv", "schurvec", "pairprod", "bandchol")
# terms.cu, lminv.cu and schurvec.cu evaluate their plain twins' per-element
# expressions operation for operation, so that per-element values agree bit
# for bit: no a * b + c may be contracted into a fused multiply-add there
# (the residual cancels terms as large as the projected pixel coordinates,
# the 3x3 determinant and cofactors cancel products of Hll entries, bsc and
# cl cancel their right-hand sides)
SOURCE_FLAGS = {name: ("-fmad=false",) for name in ("terms", "lminv", "schurvec")}


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Content-addressed path of the built library for ``csrc/<name>.cu``."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + "\0".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *_flags(name), "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _build(name, path)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def _build_missing(name: str) -> None:
    path = library_path(name)
    if not path.exists():
        _build(name, path)


def build_all() -> None:
    """Build every kernel source, one ``nvcc`` each, all started together,
    then load them (``chip_smoke.py`` times this)."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        for f in [pool.submit(_build_missing, name) for name in SOURCES]:
            f.result()
    for name in SOURCES:
        load(name)


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
