"""Pre-decoded frame cache: memmap-backed raw uint8 frames + masks (the port's
copy of checkerpose_tpu/data/framestore.py; same files, so either package
reads a cache the other wrote).

Decoding PNGs can hold a loader back on a small host, and a machine without
an image codec cannot decode them at all. Frames are decoded once (or
written raw when the fixture is generated, see `data/synthetic.py`) into
flat memmaps; a read is then a page-cache copy and the host does only the
crop and resize.

The cache is keyed by the same paths a `Sample` manifest carries, so
`CropDataset` uses it transparently: samples whose paths are present come
from the cache, everything else is decoded by `data/imageio.py`. On a machine
without an image codec the cache is the only source of frames.

Layout under `cache_dir/`:
  index.json   {"hw": [H, W], "frames": {rgb_path: row}, "masks": {mask_path: row}}
  frames.u8    memmap (n_frames, H, W, 3) RGB
  masks.u8     memmap (n_masks, H, W)

The reference pipeline has no counterpart (it decodes PNGs in DataLoader
worker processes, `train.py:156-160`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from checkerpose_tpu_torch.data.imageio import read_image

class FrameCacheWriter:
    """Append-only writer. Sizes must be known up front (memmap)."""

    def __init__(self, cache_dir: str, hw: Tuple[int, int], n_frames: int,
                 n_masks: int):
        os.makedirs(cache_dir, exist_ok=True)
        self.dir = cache_dir
        self.hw = tuple(int(x) for x in hw)
        h, w = self.hw
        self.frames = np.memmap(os.path.join(cache_dir, "frames.u8"), np.uint8,
                                "w+", shape=(max(n_frames, 1), h, w, 3))
        self.masks = np.memmap(os.path.join(cache_dir, "masks.u8"), np.uint8,
                               "w+", shape=(max(n_masks, 1), h, w))
        self.frame_index: Dict[str, int] = {}
        self.mask_index: Dict[str, int] = {}

    def add_frame(self, rgb_path: str, img_rgb: np.ndarray) -> None:
        row = len(self.frame_index)
        self.frames[row] = img_rgb
        self.frame_index[os.path.abspath(rgb_path)] = row

    def add_mask(self, mask_path: str, mask: np.ndarray) -> None:
        row = len(set(self.mask_index.values()))
        self.masks[row] = mask
        self.mask_index[os.path.abspath(mask_path)] = row

    def alias_mask(self, new_path: str, existing_path: str) -> None:
        """Second path for an identical mask (e.g. mask == mask_visib for
        fully-visible synthetic objects) without storing it twice."""
        self.mask_index[os.path.abspath(new_path)] = \
            self.mask_index[os.path.abspath(existing_path)]

    def finalize(self) -> None:
        self.frames.flush()
        self.masks.flush()
        with open(os.path.join(self.dir, "index.json"), "w") as f:
            json.dump({"hw": list(self.hw), "frames": self.frame_index,
                       "masks": self.mask_index}, f)


class FrameCache:
    """Read-only view over a finalized cache."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "index.json")) as f:
            idx = json.load(f)
        h, w = idx["hw"]
        self.hw = (h, w)
        self.frame_index = idx["frames"]
        self.mask_index = idx["masks"]
        # row counts from file size (the index may alias several paths to one row)
        fp = os.path.join(cache_dir, "frames.u8")
        mp = os.path.join(cache_dir, "masks.u8")
        n_f = max(os.path.getsize(fp) // (h * w * 3), 1)
        n_m = max(os.path.getsize(mp) // (h * w), 1)
        self.frames = np.memmap(fp, np.uint8, "r", shape=(n_f, h, w, 3))
        self.masks = np.memmap(mp, np.uint8, "r", shape=(n_m, h, w))

    def get_frame(self, rgb_path: str) -> Optional[np.ndarray]:
        row = self.frame_index.get(os.path.abspath(rgb_path))
        return None if row is None else self.frames[row]

    def get_mask(self, mask_path: str) -> Optional[np.ndarray]:
        row = self.mask_index.get(os.path.abspath(mask_path))
        return None if row is None else self.masks[row]


def build_frame_cache(samples: List, cache_dir: str) -> FrameCache:
    """Decode every unique frame/mask in `samples` once into a cache.

    Works for any BOP-layout dataset (real or synthetic); all frames must
    share one resolution.
    """
    rgb_paths, mask_paths = [], []
    seen_f, seen_m = set(), set()
    for s in samples:
        if s.rgb_path not in seen_f:
            seen_f.add(s.rgb_path)
            rgb_paths.append(s.rgb_path)
        for p in (s.mask_path, s.mask_visib_path):
            if p not in seen_m:
                seen_m.add(p)
                mask_paths.append(p)
    probe = read_image(rgb_paths[0])
    if probe is None:
        raise IOError(f"cannot decode {rgb_paths[0]}")
    h, w = probe.shape[:2]
    wr = FrameCacheWriter(cache_dir, (h, w), len(rgb_paths), len(mask_paths))
    for p in rgb_paths:
        img = read_image(p)
        if img is None:
            continue  # corrupt frames stay un-cached; loader falls back + dummies
        wr.add_frame(p, img)
    for p in mask_paths:
        m = read_image(p, gray=True)
        if m is None:
            continue
        wr.add_mask(p, m)
    wr.finalize()
    return FrameCache(cache_dir)
