"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, cached under ``.build/kernels/``
at the checkout root by a hash of the source and flags, and loaded with
ctypes. Nothing here runs at import time: the CPU tests import every
module of the package on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from ..utils.logging import Error

__all__ = [
    "KERNELS", "build", "empty_launch", "launch", "launches", "reset_launches",
    "scatter_smem_bytes",
]

_SRC = Path(__file__).resolve().parent / "csrc" / "ell_kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "kernels"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signature of each kernel's entry point (see the .cu file)
KERNELS = {
    "ell_matvec_fwd": [_P, _P, _I, _P, _P, _I, _I, _L, _P],
    "ell_matvec_bwd": [_P, _P, _I, _P, _P, _I, _I, _L, _P],
    "fm_pair_fwd": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _L, _P],
    "fm_pair_bwd": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _L, _P],
}
# entry points that are no kernel of any path (not counted)
_UNCOUNTED = {"empty_launch": [_P], "scatter_smem_bytes": [_I, _I]}

# successful launches per kernel; a run that resets these and reads them
# after its main path shows which kernels that path went through
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise Error("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def build() -> Path:
    """Compile the kernels if this source/flags pair has no library yet;
    returns the library's path. The compiler's output (register and
    shared memory use per kernel) is kept beside the library and in
    ``build_log``."""
    global build_log
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    out = _BUILD_DIR / f"ell_kernels-{key.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise Error(f"nvcc failed on {_SRC.name}:\n{build_log[-4000:]}")
    log.write_text(build_log)
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in {**KERNELS, **_UNCOUNTED}.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _call(name: str, device: torch.device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise Error(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream (appended as
    the last argument); raises on a refused launch and counts the rest."""
    _call(name, device, *args)
    launches[name] += 1


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream:
    timed like a kernel, it is the floor every launch pays. Not counted."""
    _call("empty_launch", device)


def scatter_smem_bytes(k: int) -> Dict[str, int]:
    """Dynamic shared memory of one block of each gradient scatter at ``k``
    entries a row, which the compiler's register and shared memory report
    does not include."""
    lib = _library()
    return {"ell_matvec_bwd": lib.scatter_smem_bytes(0, k),
            "fm_pair_bwd": lib.scatter_smem_bytes(1, k)}
