"""Tracing and profiling hooks of the PyTorch port: named spans, a
``torch.profiler`` trace on demand, a windowed step timer for ``fit`` and
the card's memory.

Port of ``flash_diffusion_tpu/utils/profiling.py``. ``trace_annotation``
is ``record_function``; ``profile`` writes a chrome trace (host ops, and
the card's kernels where there is one) that ``trace_top.py`` ranks;
``StepTimer`` is a ``fit`` callback with the port's signature
``(trainer, aux, step)``; ``device_memory_stats`` reads each local CUDA
device. It also holds the one mapping from the names of the port's CUDA
kernels to the TPU kernels K1–K12 they replace (``kernel_id``) and to coarse
categories (``kernel_category``), which the ``profiling.py`` and
``trace_top.py`` CLIs share.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, record_function

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named region in the profiler's timeline (a ``record_function``
    span, with its device-side span where the card runs)."""
    with record_function(name):
        yield


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (CPU ops, and CUDA
    kernels where a card is present) and write it as ``trace.json`` into
    ``log_dir`` (default: ``torch-trace`` in the temporary directory).
    Yields the trace's path; the file is written when the block ends."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def _synchronize(trainer) -> None:
    device = torch.device(getattr(trainer, "device", "cpu"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """``fit`` callback: the mean step time and steps/s over each window of
    ``window`` steps, logged as JAX's timer logs it. The first call starts
    the clock; the device of the trainer's state is synchronized before
    each reading. ``history`` keeps (step, s/step) of every window."""

    def __init__(self, window: int = 10, name: str = "train"):
        self.window = window
        self.name = name
        self.history = []
        self._t0: Optional[float] = None
        self._count = 0

    def __call__(self, trainer, aux, step: int) -> None:
        if self._t0 is None:
            _synchronize(trainer)
            self._t0 = time.perf_counter()
            self._count = 0
            return
        self._count += 1
        if self._count >= self.window:
            _synchronize(trainer)
            dt = (time.perf_counter() - self._t0) / self._count
            self.history.append((step, dt))
            logger.info("%s step %d: %.3fs/step (%.2f steps/s)", self.name, step, dt, 1.0 / dt)
            self._t0 = time.perf_counter()
            self._count = 0


def device_memory_stats() -> dict:
    """{``cuda:i``: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for each
    local CUDA device (the caching allocator's current and peak allocated
    bytes, and the card's total memory); an empty dict without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        try:
            s = torch.cuda.memory_stats(i)
            stats[f"cuda:{i}"] = {
                "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.mem_get_info(i)[1],
            }
        except RuntimeError:
            stats[f"cuda:{i}"] = None
    return stats


# -- the port's kernels by name ------------------------------------------------
def is_packed(name: str) -> bool:
    """Whether a kernel is a packed [B, S, H·D] attention forward: an
    instantiation with kPacked = true (K4 of K1's kernel, K5 of K2's), or a
    kernel of its own (``flash_fwd_oneshot_packed_kernel``,
    ``flash_fwd_packed_kernel``), so that a tree of either kind profiles
    alike."""
    return ", true>" in name or "_packed_kernel" in name


def is_geglu(name: str) -> bool:
    """Whether a kernel is K12: K10's kernel instantiated with kGeglu =
    true (``gemm_sm90_kernel<BN, kCluster, true>``)."""
    return "gemm_sm90_kernel" in name and ", true>" in name


# (tag, whether a kernel's full name is of it): the TPU kernel each CUDA
# kernel replaces (PERF.md's table); "K9 fused" is the resident GroupNorm
# (K9's statistics with the fold and the apply in one launch), "GN apply"
# the GroupNorm's apply pass, which has no TPU kernel (XLA fuses it)
KERNEL_IDS: Tuple[Tuple[str, Callable[[str], bool]], ...] = (
    ("K2", lambda n: ("flash_fwd_wgmma_kernel" in n or "flash_fwd_mma_kernel" in n) and not is_packed(n)),
    ("K5", lambda n: is_packed(n) and ("flash_fwd_wgmma_kernel" in n or "flash_fwd_packed_kernel" in n)),
    ("K10", lambda n: "gemm_sm90_kernel" in n and not is_geglu(n)),
    ("K12", is_geglu),
    ("K11", lambda n: "int8_gemm_kernel" in n),
    ("K1", lambda n: "flash_fwd_oneshot_kernel" in n and not is_packed(n)),
    ("K4", lambda n: is_packed(n) and "flash_fwd_oneshot" in n),
    ("K8", lambda n: "flash_bwd_oneshot" in n),
    ("K6", lambda n: "flash_bwd_dkv" in n),
    ("K7", lambda n: "flash_bwd_dq" in n),
    ("K3", lambda n: "layer_norm_" in n and "kernel" in n),
    ("K9 fused", lambda n: "gn_resident" in n),
    ("K9", lambda n: "gn_stats" in n),
    ("GN apply", lambda n: "gn_apply" in n),
)


def kernel_id(name: str) -> Optional[str]:
    """The tag of ``KERNEL_IDS`` of a kernel's full (demangled) name, or
    None for a kernel that is not one of the port's own."""
    return next((tag for tag, takes in KERNEL_IDS if takes(name)), None)


def kernel_category(name: str) -> str:
    """A coarse category of any kernel by name: the port's kernels by kind,
    then cuDNN's convolutions, the library GEMMs, reductions, elementwise
    passes and copies."""
    low = name.lower()
    for key, cat in (
        ("flash_fwd", "attention kernels"), ("flash_bwd", "attention kernels"),
        ("layer_norm_", "layer_norm kernel"), ("int8_gemm_kernel", "int8 gemm kernel"),
        ("gemm_sm90_kernel", "ffn gemm kernels"),
        ("gn_stats", "group_norm kernels"), ("gn_apply", "group_norm kernels"), ("gn_resident", "group_norm kernels"),
        ("fprop", "convolution"), ("conv", "convolution"), ("gemm", "gemm (linear)"),
        ("nvjet", "gemm (linear)"), ("cutlass", "gemm (linear)"),
        ("reduce", "reduction"), ("elementwise", "elementwise"), ("vectorized", "elementwise"),
        ("copy", "copy / layout"), ("cat", "copy / layout"),
    ):
        if key in low:
            return cat
    return "other"
