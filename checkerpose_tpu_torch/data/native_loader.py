"""ctypes binding of the native decode + crop core (counterpart of
checkerpose_tpu/data/native_loader.py, the same C ABI: `lc_load_sample`,
`lc_load_batch`).

The core is the JAX package's `native/loadercore.cpp`: PNG / JPEG decode
(libpng, libjpeg), the zero-padded square crop and the resize (bilinear for
the image, nearest for the two masks) with cv2's geometry, one C call a
sample or a whole batch over a thread pool. The port compiles that source
with g++ and native/Makefile's flags at first use, into `build/` at the repo
root under a name hashed from the source, the flags and this host's CPU
(`-march=native`), and never loads the library committed under `native/`,
which another host's CPU built. Where the build fails (no g++, or no
libpng / libjpeg headers) `available()` is False and `build_error()` says
why; `CropDataset` then keeps its python path.

`counts` holds the items (samples) and batches the core has loaded in this process
(`reset_counts()` zeroes them), which shows whether a run took this path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "loadercore.cpp"
BUILD_DIR = _ROOT / "build"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]      # native/Makefile
LDLIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]

counts: Dict[str, int] = {"items": 0, "batches": 0}
_state: Dict[str, object] = {"lib": None, "error": None}
_lock = threading.Lock()

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_U8_P = ctypes.POINTER(ctypes.c_uint8)
_F32_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)
_STR_ARR = ctypes.POINTER(ctypes.c_char_p)


def _cpu_id() -> bytes:
    """This host's CPU model and feature flags (what -march=native targets)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(sorted({ln for ln in f if ln.startswith((b"model name", b"flags"))}))
    except OSError:
        return b""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDLIBS).encode()
                       + _cpu_id()).hexdigest()[:16]
    return BUILD_DIR / f"libloadercore-{h}.so"


def build() -> Path:
    """Compile the core unless this host's build exists; the library's path.
    Raises RuntimeError with g++'s output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE), *LDLIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr}")
    os.replace(tmp, lib)        # concurrent builders each rename a whole library
    return lib


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                _state["error"] = str(e)
            else:
                lib.lc_load_sample.restype = ctypes.c_int
                lib.lc_load_sample.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, _DOUBLE_P,
                    ctypes.c_int, ctypes.c_int, _U8_P, _F32_P, _F32_P, _INT_P]
                lib.lc_load_batch.restype = ctypes.c_int
                lib.lc_load_batch.argtypes = [
                    ctypes.c_int, _STR_ARR, _STR_ARR, _STR_ARR, _DOUBLE_P,
                    ctypes.c_int, ctypes.c_int, _U8_P, _F32_P, _F32_P, ctypes.c_int]
                _state["lib"] = lib
        return _state["lib"]


def available() -> bool:
    """True when the core builds (or is built) and loads on this host."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the core is unavailable (g++'s output), or None."""
    _load()
    return _state["error"]


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loadercore unavailable: {_state['error']}")
    return lib


def _count(key: str, n: int):
    with _lock:
        counts[key] += n


def reset_counts():
    with _lock:
        for k in counts:
            counts[k] = 0


def _check_sizes(crop_img: int, crop_gt: int):
    if int(crop_img) <= 0 or int(crop_gt) <= 0:
        raise ValueError(f"crop sizes must be positive, got {crop_img}, {crop_gt}")


def load_sample(rgb_path: str, mask_path: str, mask_visib_path: str,
                bbox: np.ndarray, crop_img: int, crop_gt: int):
    """(img uint8 (S, S, 3), mask_full f32 (G, G), mask_visib f32 (G, G),
    (img_w, img_h)) of one sample; raises IOError when a file does not
    decode."""
    lib = _lib()
    _check_sizes(crop_img, crop_gt)
    b = np.ascontiguousarray(bbox, np.float64)
    if b.shape != (4,):
        raise ValueError(f"bbox must be (4,), got {b.shape}")
    img = np.empty((crop_img, crop_img, 3), np.uint8)
    mf = np.empty((crop_gt, crop_gt), np.float32)
    mv = np.empty((crop_gt, crop_gt), np.float32)
    wh = np.zeros(2, np.int32)
    rc = lib.lc_load_sample(
        os.fsencode(rgb_path), os.fsencode(mask_path), os.fsencode(mask_visib_path),
        b.ctypes.data_as(_DOUBLE_P), crop_img, crop_gt, img.ctypes.data_as(_U8_P),
        mf.ctypes.data_as(_F32_P), mv.ctypes.data_as(_F32_P), wh.ctypes.data_as(_INT_P))
    if rc != 0:
        raise IOError(f"loadercore failed rc={rc} for {rgb_path}")
    _count("items", 1)
    return img, mf, mv, (int(wh[0]), int(wh[1]))


def load_batch(rgb_paths: List[str], mask_paths: List[str], mask_visib_paths: List[str],
               bboxes: np.ndarray, crop_img: int, crop_gt: int, num_threads: int = 0):
    """A batch decoded and cropped in one call over the core's thread pool
    (`num_threads` 0: one a hardware thread). Samples that fail are
    zero-filled; returns (imgs, masks_full, masks_visib, n_failures)."""
    lib = _lib()
    _check_sizes(crop_img, crop_gt)
    B = len(rgb_paths)
    b = np.ascontiguousarray(bboxes, np.float64)
    if b.shape != (B, 4) or len(mask_paths) != B or len(mask_visib_paths) != B:
        raise ValueError(f"{B} rgb paths, {len(mask_paths)} and {len(mask_visib_paths)} "
                         f"mask paths, bboxes {b.shape}")
    imgs = np.empty((B, crop_img, crop_img, 3), np.uint8)
    mf = np.empty((B, crop_gt, crop_gt), np.float32)
    mv = np.empty((B, crop_gt, crop_gt), np.float32)

    def carr(paths):
        arr = (ctypes.c_char_p * B)()
        arr[:] = [os.fsencode(p) for p in paths]
        return arr

    rgb_a, mf_a, mv_a = carr(rgb_paths), carr(mask_paths), carr(mask_visib_paths)
    fails = lib.lc_load_batch(
        B, rgb_a, mf_a, mv_a, b.ctypes.data_as(_DOUBLE_P), crop_img, crop_gt,
        imgs.ctypes.data_as(_U8_P), mf.ctypes.data_as(_F32_P), mv.ctypes.data_as(_F32_P),
        int(num_threads))
    _count("items", B)
    _count("batches", 1)
    return imgs, mf, mv, int(fails)
