"""The native JPEG decoder (port of ``flash_diffusion_tpu/data/native_decode.py``).

One C call (``data/native/fastjpeg.cpp``, the port's own copy of the JAX
package's source) does decode → DCT prescale → bilinear cover-resize →
center crop → float32 [-1, 1]; ctypes releases the GIL for it, so thread
workers decode on several host cores at once.

The library builds at first use with ``g++ -O3 -shared -fPIC … -ljpeg``
(first with ``-march=native -funroll-loops``, as JAX builds it, then
without) into ``build/native/`` at the checkout's root, named by a hash of
the source, the flags and the host's CPU model, so that a library built on
another machine is never loaded; a second process finds it built. Without
``g++`` or ``libjpeg`` the build fails, ``is_available()`` is False (as in
JAX) and the warning, and ``BUILD_INFO["error"]``, give the compiler's first
error line. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .mappers import BaseMapper, BaseMapperConfig

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "native" / "fastjpeg.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAG_SETS = (["-march=native", "-funroll-loops"], [])
# filled by the first load: the library's path, the flags and seconds of a
# build (0 when it was built before), or the first error line of a failure
BUILD_INFO: dict = {}
_lock = threading.Lock()
_lib = None
_failed = False


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path(flags) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_cpu_model().encode())
    return BUILD_DIR / f"libfastjpeg_{h.hexdigest()[:16]}.so"


def _first_error(text: str) -> str:
    lines = [line.strip() for line in text.splitlines() if line.strip()]
    return next((line for line in lines if "error" in line.lower()), lines[0] if lines else "no output")


def _build() -> Optional[Path]:
    """The library of the first flag set that builds (cached), or None."""
    errors = []
    for flags in FLAG_SETS:
        path = library_path(flags)
        if path.exists():
            BUILD_INFO.update(path=str(path), flags=flags, seconds=0.0)
            return path
        t0 = time.perf_counter()
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
                tmp = os.path.join(work, "lib.so")
                run = subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC", str(SRC), "-ljpeg", "-o", tmp],
                                     capture_output=True, text=True, timeout=120)
                if run.returncode != 0:
                    errors.append(_first_error(run.stderr + run.stdout))
                    continue
                os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{type(e).__name__}: {e}")
            continue
        BUILD_INFO.update(path=str(path), flags=flags, seconds=time.perf_counter() - t0)
        return path
    BUILD_INFO["error"] = errors[-1]
    logger.warning("native decoder build failed (%s); using PIL", errors[-1])
    return None


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        if path is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            BUILD_INFO["error"] = str(e)
            logger.warning("native decoder load failed (%s); using PIL", e)
            _failed = True
            return None
        lib.fj_decode_to_tensor.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        lib.fj_decode_to_tensor.restype = ctypes.c_int
        _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library builds (or was built) and loads here."""
    return _load() is not None


def decode_to_tensor(data: bytes, height: int, width: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG bytes → (float32 [-1, 1] HWC (height, width, 3), the file's
    (h, w)); ValueError on bytes that do not decode (the pipeline skips
    the sample, as it skips any corrupt member)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    if height <= 0 or width <= 0:
        raise ValueError(f"bad target size {(height, width)}")
    out = np.empty((height, width, 3), np.float32)
    orig = (ctypes.c_int * 2)()
    rc = lib.fj_decode_to_tensor(data, len(data), height, width,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), orig)
    if rc != 0:
        raise ValueError(f"native jpeg decode failed (rc={rc})")
    return out, (int(orig[0]), int(orig[1]))


@dataclasses.dataclass
class NativeDecodeMapperConfig(BaseMapperConfig):
    """``key`` holds raw JPEG bytes (the pipeline's ``raw_image`` decoder)."""

    height: int = 512
    width: int = 512
    output_key: Optional[str] = None
    emit_micro_conds: bool = False  # SDXL's size tuples from the file's size


class NativeDecodeMapper(BaseMapper):
    """Raw JPEG bytes → float32 [-1, 1] (height, width, 3) in one native call
    (in place of decode, resize, center crop, to-tensor and rescale). A
    non-JPEG image, which the ``raw_image`` decoder hands over as PIL, takes
    the same cover-resize and center crop through PIL instead."""

    def _pil_fallback(self, img):
        from PIL import Image

        cfg = self.config
        img = img.convert("RGB") if img.mode != "RGB" else img
        w0, h0 = img.size
        s = max(cfg.height / h0, cfg.width / w0)
        rw, rh = max(cfg.width, round(w0 * s)), max(cfg.height, round(h0 * s))
        img = img.resize((rw, rh), Image.BILINEAR)
        left, top = (rw - cfg.width) // 2, (rh - cfg.height) // 2
        img = img.crop((left, top, left + cfg.width, top + cfg.height))
        return np.asarray(img, np.float32) / 127.5 - 1.0, (h0, w0)

    def __call__(self, sample):
        cfg = self.config
        data = sample[cfg.key]
        if isinstance(data, (bytes, bytearray)):
            arr, (h0, w0) = decode_to_tensor(bytes(data), cfg.height, cfg.width)
        elif hasattr(data, "size") and hasattr(data, "crop"):  # a PIL image
            arr, (h0, w0) = self._pil_fallback(data)
        else:
            raise TypeError(f"{cfg.key} must be raw jpeg bytes or a PIL image (decoder='raw_image'), "
                            f"got {type(data)}")
        out = dict(sample)
        out[cfg.output_key or cfg.key] = arr
        if cfg.emit_micro_conds:
            out["original_size_as_tuple"] = np.asarray([h0, w0], np.float32)
            out["crop_coords_top_left"] = np.zeros((2,), np.float32)
            out["target_size_as_tuple"] = np.asarray([cfg.height, cfg.width], np.float32)
        return out
