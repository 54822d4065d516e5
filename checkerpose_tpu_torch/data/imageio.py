"""PNG/JPEG files through whichever codec imports: OpenCV, else Pillow.

The port's data path needs neither (frames and masks come from the frame
cache, `data/framestore.py`, and crops are resized in numpy, `ops/crop.py`);
a file is decoded or encoded only through these helpers, and a decode with
no codec installed raises an error that says how to do without one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class NoImageCodecError(RuntimeError):
    pass


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def have_codec() -> bool:
    return _cv2() is not None or _pil_image() is not None


def read_image(path: str, gray: bool = False) -> Optional[np.ndarray]:
    """(H, W, 3) RGB or, with gray, (H, W) uint8; None when the file is
    missing or does not decode."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None or gray:
            return img
        return np.ascontiguousarray(img[:, :, ::-1])
    Image = _pil_image()
    if Image is None:
        raise NoImageCodecError(
            f"cannot decode {path}: neither cv2 nor PIL is importable. Read frames and "
            f"masks from a frame cache instead (data/framestore.py::build_frame_cache on a "
            f"machine with a codec, or make_synthetic_bop(..., raw_cache=True)); "
            f"cfg frame_cache_dir names it")
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("L" if gray else "RGB"))
    except OSError:
        return None


def write_png(path: str, img: np.ndarray) -> bool:
    """Write (H, W, 3) RGB or (H, W) uint8 as PNG; False when no codec is
    importable (nothing written)."""
    cv2 = _cv2()
    if cv2 is not None:
        return bool(cv2.imwrite(path, img[:, :, ::-1] if img.ndim == 3 else img))
    Image = _pil_image()
    if Image is None:
        return False
    Image.fromarray(np.ascontiguousarray(img)).save(path)
    return True
