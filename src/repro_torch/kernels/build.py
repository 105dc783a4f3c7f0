"""Builds the hand-written CUDA kernels at first use and binds them.

``csrc/butterfly.cu`` has a plain C interface: ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under the build directory, and
``ctypes`` loads it.  The library's file name carries the source's hash,
so an edited source is rebuilt and an unchanged one is reused.  The
build directory is ``build/repro_torch_kernels/`` at the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides it).

There is no fallback: a missing ``nvcc`` or a failed build raises.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "butterfly.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return SOURCE.parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(pathlib.Path(which))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found ($CUDA_HOME/bin, PATH, "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "repro_torch cannot be built")


def _compile(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tables = [p, p, p, p, p]
    lib.g_chain_launch.argtypes = ([p, p, i, i, i] + tables
                                   + [ll, i, i, i, i, i, p])
    lib.g_chain_launch.restype = i
    lib.g_operator_launch.argtypes = ([p, p, p, i, i, i]
                                      + tables + [ll, i, i, i]
                                      + tables + [ll, i, i, i]
                                      + [i, i, p])
    lib.g_operator_launch.restype = i
    lib.repro_max_smem_optin.argtypes = []
    lib.repro_max_smem_optin.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
            out = build_dir() / f"libbutterfly_{digest}.so"
            if not out.is_file():
                _compile(out)
            _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
