"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a cold
build takes seconds). The library lands in ``build/kernels/`` at the
checkout's root, named by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so a second process or a rerun skips
``nvcc``. Nothing here runs at import time: the first kernel launch builds
and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by the build: library path, seconds spent in nvcc (0 when cached),
# and nvcc's output (ptxas register / shared-memory / spill report)
BUILD_INFO: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fdt_attn_smem_bytes": [_I, _I, _I],
    "fdt_flash_fwd_oneshot": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "fdt_flash_fwd_stream_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "fdt_flash_fwd_stream_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "fdt_flash_fwd_wgmma_tiles": [_I, _P],
    "fdt_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "fdt_flash_fwd_oneshot_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "fdt_flash_fwd_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "fdt_flash_bwd_oneshot_tiles": [_I, _I, _P],
    "fdt_flash_bwd_pair_tiles": [_I, _I, _P],
    "fdt_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F] + [_P],
    "fdt_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_F] + [_P],
    "fdt_flash_bwd_oneshot": [_P] * 10 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    "fdt_int8_gemm": [_P] * 6 + [_I] * 6 + [_P],
    "fdt_int8_gemm_plan": [_I] * 5 + [_P],
    "fdt_gemm_sm90": [_P] * 4 + [_I] * 4 + [_P],
    "fdt_gemm_plan": [_I] * 3 + [_P],
    "fdt_geglu_gemm": [_P] * 4 + [_I] * 5 + [_P],
    "fdt_geglu_gemm_plan": [_I] * 4 + [_P],
    "fdt_geglu_gemm_occupancy": [_I] * 2 + [_P],
    "fdt_group_norm_stats": [_P] * 12 + [_I] * 10 + [_F] + [_P],
    "fdt_group_norm_apply": [_P] * 4 + [_I] * 7 + [_P],
    "fdt_group_norm_resident": [_P] * 6 + [_I] * 11 + [_F] + [_P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists: one
    ``nvcc -c`` per source, all running at once, then one link."""
    path = library_path()
    if path.exists():
        BUILD_INFO.update(path=str(path), seconds=0.0, log="(cached)")
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        procs = []
        for src in _sources():
            obj = os.path.join(work, src.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs = [(p.communicate()[0], p.returncode) for _, p in procs]  # waits for every one
        log = "".join(out for out, _ in logs)
        if any(rc != 0 for _, rc in logs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *(o for o, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    BUILD_INFO.update(path=str(path), seconds=time.perf_counter() - t0, log=log)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")
