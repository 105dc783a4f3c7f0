"""Builds the hand-written CUDA kernels at first use and binds them.

Every ``csrc/*.cu`` has a plain C interface: ``nvcc`` compiles each for
Hopper (``sm_90a``) into an object file, all sources at once in parallel
processes, and links the objects into ONE shared library under the build
directory, which ``ctypes`` loads.  The library's file name carries the
hash of every source and header under ``csrc/``, so an edited source is
rebuilt and an unchanged set is reused.  The build directory is
``build/repro_torch_kernels/`` at the repository root
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

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "repro_torch_kernels"


def sources() -> list:
    """The kernel sources, one translation unit each."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


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


def _run_all(cmds) -> None:
    """Run the commands as parallel processes; raise with the compiler's
    output if any failed (after all have ended)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    bad = [(c, o, rc) for c, o, rc in outs if rc != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"({rc}) {' '.join(c)}\n{o}" for c, o, rc in bad))


def _compile(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f"{src.stem}_{out.stem}.{tag}.o" for src in sources()]
    tmp = out.with_suffix(f".{tag}.so")
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [p, p, i, i, i]                   # x, y, B, R, n
    # a chain or operator leg is a stream: words, stage offsets, S, s0,
    # ns; their geometry is (lanes per row, rows per warp, warps per CTA)
    stream_leg = [p, p, i, i, i]
    rows = [i, i, i, p]                      # geometry, stream
    # each family's f32 form, its bf16-table form (the kernels
    # <family>_*_bf16_kernel) and its bf16-signal form (<family>_*_xbf16_
    # kernel) take the same arguments
    for family, tables in (("g", 5), ("t", 4)):
        for form in ("", "_bf16", "_xbf16"):
            chain = getattr(lib, f"{family}_chain{form}_launch")
            chain.argtypes = head + stream_leg + rows
            chain.restype = i
            op = getattr(lib, f"{family}_operator{form}_launch")
            op.argtypes = head + [p] + stream_leg + stream_leg + rows
            op.restype = i
            # a bank leg is its tables, stage extents, matrix stride, P,
            # s0, ns; the bank's geometry is (rows, filters) per CTA and
            # threads
            bank_leg = [p] * (tables + 1) + [ll, i, i, i]
            bank = getattr(lib, f"{family}_bank{form}_launch")
            bank.argtypes = (head + [p, i] + bank_leg + bank_leg
                             + [i, i, i, p])
            bank.restype = i
            occ = getattr(lib, f"{family}{form}_occupancy")
            occ.argtypes = [i, i, i, i, i]   # kind, rows, n, P, threads
            occ.restype = i
    for fn in (lib.repro_max_smem_optin, lib.repro_smem_per_sm):
        fn.argtypes = []
        fn.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = build_dir() / f"librepro_torch_kernels_{_digest()}.so"
            if not out.is_file():
                _compile(out)
            _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
