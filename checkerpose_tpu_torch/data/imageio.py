"""PNG/JPEG files through whichever codec imports: OpenCV, else Pillow, else
this module's own PNG codec.

The port's data path needs neither library (frames and masks come from the
frame cache, `data/framestore.py`, and crops are resized in numpy,
`ops/crop.py`); a file is decoded or encoded only through these helpers.
With no library installed, `read_image` decodes 8-bit grayscale and RGB PNGs
(the lm_imgn renders and background images are colour PNGs) with the small
zlib codec below, and anything else (a JPEG, a missing file) raises an error
that says how to do without a library.

Depth maps (BOP ships them as 16-bit single-channel PNGs) go through
`read_depth_png` / `write_depth_png`, values unchanged, by the same codec
whichever image library is installed, so that VSD scoring and the synthetic
fixture read and write them one way; `write_rgb_png` writes colour PNGs
through it. Rows with the none, sub or up filter decode in numpy; average
and Paeth rows go through a per-byte loop. `png_size` reads a PNG's width
and height from its header alone.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


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
    missing or does not decode. Without cv2 and Pillow, an 8-bit grayscale
    or RGB PNG decodes through `decode_png` (a gray file read as colour is
    repeated over the channels; read as gray, an RGB file is refused), and
    anything else raises NoImageCodecError."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None or gray:
            return img
        return np.ascontiguousarray(img[:, :, ::-1])
    Image = _pil_image()
    if Image is None:
        try:
            with open(path, "rb") as f:
                img = decode_png(f.read())
        except OSError:
            img = None
        if img is not None and img.dtype == np.uint8:
            if img.ndim == (2 if gray else 3):
                return img
            if not gray:                                # a gray file read as colour
                return np.repeat(img[:, :, None], 3, axis=2)
        raise NoImageCodecError(
            f"cannot decode {path}: neither cv2 nor PIL is importable, and the package's "
            f"own codec reads 8-bit grayscale and RGB PNG files only. Read frames and "
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


def png_size(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from a PNG's IHDR chunk, reading 24 bytes; None when
    the file is missing or is no PNG."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return None
    if len(head) < 24 or head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", head[16:24])


def read_depth_png(path: str) -> Optional[np.ndarray]:
    """A single-channel PNG as stored ((H, W) uint16 for a 16-bit file);
    None when the file is missing or is no non-interlaced grayscale PNG."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_gray_png(data)


def write_depth_png(path: str, depth: np.ndarray) -> None:
    """Write (H, W) uint16 as a 16-bit grayscale PNG, values unchanged."""
    with open(path, "wb") as f:
        f.write(encode_gray16_png(np.ascontiguousarray(depth, np.uint16)))


def write_rgb_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as an 8-bit colour PNG through the
    package's own encoder (no image library needed)."""
    with open(path, "wb") as f:
        f.write(encode_rgb_png(img))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _encode(samples: np.ndarray, w: int, h: int, depth: int, color: int) -> bytes:
    """PNG bytes of (h, row bytes) uint8 samples: one IDAT, filter type 0
    on every row."""
    rows = np.zeros((h, 1 + samples.shape[1]), np.uint8)   # column 0: the filter byte
    rows[:, 1:] = samples
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def encode_gray16_png(depth: np.ndarray) -> bytes:
    """PNG bytes of (H, W) uint16, samples big-endian."""
    h, w = depth.shape
    return _encode(depth.astype(">u2").view(np.uint8).reshape(h, 2 * w), w, h, 16, 0)


def encode_rgb_png(img: np.ndarray) -> bytes:
    """PNG bytes of (H, W, 3) uint8 RGB (colour type 2, 8 bits)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {img.shape}")
    h, w = img.shape[:2]
    return _encode(img.reshape(h, 3 * w), w, h, 8, 2)


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one PNG row filter (0 none, 1 sub, 2 up, 3 average, 4 Paeth) on
    uint8 bytes, given the row above already reconstructed."""
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prior                              # uint8 arithmetic wraps mod 256
    if ftype == 1:
        # x[i] = raw[i] + x[i - bpp]: a running sum along each byte lane
        lanes = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"PNG filter type {ftype}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


# (colour type, bit depth) -> samples per pixel, of the PNGs `decode_png` reads
_FORMATS = {(0, 8): 1, (0, 16): 1, (2, 8): 3}


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """A non-interlaced PNG of 8- or 16-bit grayscale ((H, W) uint8 or
    uint16) or 8-bit RGB ((H, W, 3) uint8); None for anything else
    (another colour type, bit depth or interlace)."""
    if data[:8] != _PNG_SIG:
        return None
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        return None
    w, h, depth, color, _, _, interlace = hdr
    spp = _FORMATS.get((color, depth))
    if spp is None or interlace != 0:
        return None
    bpp = spp * depth // 8                              # bytes per pixel
    stride = 1 + w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * stride:
        return None
    raw = raw[:h * stride].reshape(h, stride)
    out = np.empty((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    if depth == 16:
        return out.view(">u2").reshape(h, w).astype(np.uint16)
    return out.reshape(h, w, 3) if spp == 3 else out


def decode_gray_png(data: bytes) -> Optional[np.ndarray]:
    """(H, W) uint16 or uint8 of a non-interlaced 16- or 8-bit grayscale PNG;
    None for anything else."""
    img = decode_png(data)
    return img if img is not None and img.ndim == 2 else None
