"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` (Hopper)
into one shared library with a plain C interface, loaded with ``ctypes``.
Each ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and the objects link into one ``.so``. The library lands in
``build/torch_kernels/<hash>/`` under the repository checkout, keyed on a
hash of every source and flag, so the first call after a source change
rebuilds and later calls load the cached library. Nothing here runs when a
module is imported: the CPU tests import every module and this machine
need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_ROOT = os.path.join(_REPO, "build", "torch_kernels")
LIB_NAME = "libpicotron_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every exported C function: name -> argtypes (each returns a cudaError_t
# as int, 0 on success)
SIGNATURES = {
    "picotron_rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _P],
    "picotron_rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "picotron_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _F, _P],
    "picotron_flash_attention_bwd_dq": [_P] * 8 + [_I] * 5 + [_F, _P],
    "picotron_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _P],
    "picotron_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _P],
    "picotron_flash_decode_int8": [_P] * 7 + [_I] * 6 + [_F, _P],
    "picotron_quant_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
}


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it. ``launches`` is a plain counter
    that the wrapper bumps right after each launch and nowhere else;
    callers that want a window reset it to 0."""

    name: str
    route: str  # "cuda" | "triton"
    source: str  # repo-relative path of the source
    replaces: str  # file:line of the Pallas TPU kernel
    launches: int = 0


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit's compiler (set CUDA_HOME)")
    return found


def _run_all(cmds: list) -> list:
    """Start every command at once, wait for all; (cmd, returncode,
    output) each. Every process started here has ended on return."""
    procs = []
    try:
        for cmd in cmds:
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outs = [p.communicate()[0] for _, p in procs]
        return [(cmd, p.returncode, out)
                for (cmd, p), out in zip(procs, outs)]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> str:
    """Compile the library if this source hash has none; return its path.
    The compiler's output (register and shared-memory use per kernel)
    is kept beside it as ``build.log``."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_ROOT, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT)
    try:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in _sources()]
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                            for src, obj in zip(_sources(), objs)])
        log = [f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in results]
        bad = [cmd[-3] for cmd, rc, _ in results if rc != 0]
        if bad:
            raise RuntimeError(f"nvcc failed for {bad}:\n" + "\n".join(log))
        (cmd, rc, out), = _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared",
                                     "-o", os.path.join(tmp, LIB_NAME),
                                     *objs]])
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if rc != 0:
            raise RuntimeError("linking the kernels failed:\n"
                               + "\n".join(log))
        with open(os.path.join(tmp, "build.log"), "w") as f:
            f.write("\n".join(log))
        os.makedirs(out_dir, exist_ok=True)
        os.replace(os.path.join(tmp, "build.log"),
                   os.path.join(out_dir, "build.log"))
        os.replace(os.path.join(tmp, LIB_NAME), lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.picotron_error_string.argtypes = [ctypes.c_int]
    lib.picotron_error_string.restype = ctypes.c_char_p
    return lib


def timed_library() -> float:
    """Load the library, building it if needed; the seconds it took."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def check(rc: int, kernel: Kernel) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = library().picotron_error_string(rc).decode()
        raise RuntimeError(f"{kernel.name} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
