"""Crop dataset + host input pipeline (counterpart of
checkerpose_tpu/data/dataset.py: `CropDataset`, `Loader`, `MixedLoader`,
`mixed_batch_sizes`).

Host side (here): frame read, bbox selection (train jitter / test padding or
detector box), crop + resize, keypoint projection, and the train-time
background replacement, all numpy. Device side (train and eval steps): color
augmentation, ImageNet normalization and the GT binary-code labels. Batches
are dicts of stacked numpy arrays; a background thread prefetches ahead of
the card.

Frames and masks come from the frame cache when one is given
(`data/framestore.py`), else from the image files through `data/imageio.py`;
lm_imgn renders (`data/lm_imgn.py`) take both masks from depth > 0. The
multi-object variant passes a {obj_id: (N, 3)} keypoint table: each item
then carries `obj_idx`, its object's row in the stacked keypoint and graph
tables.

With frames on disk and no frame cache, the native C++ core
(`data/native_loader.py`) decodes and crops instead, an item a call or, through
`get_batch`, a whole batch a call over its thread pool; `Loader` takes that
batch API when the dataset offers it.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from checkerpose_tpu_torch.data import native_loader
from checkerpose_tpu_torch.data.bop_io import Sample
from checkerpose_tpu_torch.data.imageio import read_depth_png, read_image
from checkerpose_tpu_torch.ops import geometry
from checkerpose_tpu_torch.ops.crop import get_roi_np, resize_linear_u8, roi_window


class CropDataset:
    """Crop dataset over a Sample manifest, of one object or several."""

    def __init__(self, samples: List[Sample], p3d_xyz, *,
                 is_train: bool, crop_size_img: int = 256, crop_size_gt: int = 64,
                 padding_ratio: float = 1.5, resize_method: str = "crop_square_resize",
                 use_detections: bool = False, seed: int = 0,
                 bg_paths: Optional[List[str]] = None, change_bg_prob: float = 0.0,
                 use_native: Optional[bool] = None, frame_cache=None):
        """p3d_xyz: (N, 3) keypoints shared by all samples, or a
        {obj_id: (N, 3)} table for the multi-object variant; items then carry
        `obj_idx`, the object's rank among the sorted ids (the row of the
        stacked keypoint and graph tables), else 0.

        bg_paths / change_bg_prob: train-time background replacement (the
        reference's VOC background swap, `lm_dataset_pytorch.py:489-523`):
        the pixels outside the full mask take a random background image's,
        always for "syn" samples and with probability change_bg_prob for the
        others.

        use_native: decode and crop through the native core (None: wherever
        it builds and neither a background swap, which needs the whole
        frame's mask, nor a frame cache, which already skips the decode, is
        on). Samples with a depth_path (lm_imgn renders) keep the python
        path, and so does a sample the core cannot decode."""
        self.samples = samples
        if isinstance(p3d_xyz, dict):
            self.p3d_table = {k: np.asarray(v, np.float64) for k, v in p3d_xyz.items()}
            self.obj_id_to_idx = {oid: i for i, oid in enumerate(sorted(self.p3d_table))}
            self.p3d = next(iter(self.p3d_table.values()))
        else:
            self.p3d_table = None
            self.obj_id_to_idx = None
            self.p3d = np.asarray(p3d_xyz, np.float64)
        self.bg_paths = bg_paths
        self.change_bg_prob = change_bg_prob
        self.frame_cache = frame_cache
        if use_native is None:
            use_native = not bg_paths and frame_cache is None
        self.use_native = bool(use_native) and not bg_paths and native_loader.available()
        self.is_train = is_train
        self.crop_size_img = crop_size_img
        self.crop_size_gt = crop_size_gt
        self.padding_ratio = padding_ratio
        self.resize_method = resize_method
        self.use_detections = use_detections
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples)

    def _obj_idx(self, s: Sample) -> np.int32:
        return np.int32(self.obj_id_to_idx[s.obj_id] if self.obj_id_to_idx else 0)

    def dummy_item(self, s: Sample) -> Dict[str, np.ndarray]:
        """Missing detection or unreadable frame -> zero input with
        `valid`=0, which eval leaves out."""
        S, G = self.crop_size_img, self.crop_size_gt
        return {
            "image": np.zeros((S, S, 3), np.uint8),
            "mask_visib": np.zeros((G, G), np.float32),
            "mask_full": np.zeros((G, G), np.float32),
            "R": s.R.astype(np.float32), "t": s.t.astype(np.float32),
            "bbox": np.zeros(4, np.float32),
            "cam_K": s.cam_K.astype(np.float32),
            "proj_xy": np.zeros((self.p3d.shape[0], 2), np.float32),
            "obj_id": np.int32(s.obj_id), "obj_idx": self._obj_idx(s),
            "scene_id": np.int32(s.scene_id), "im_id": np.int32(s.im_id),
            "valid": np.float32(0.0),
        }

    def _choose_bbox(self, s: Sample) -> np.ndarray:
        """Train: jittered GT bbox; eval: padded detector or GT bbox."""
        if self.is_train:
            return geometry.aug_bbox(s.bbox_visib, self.padding_ratio, self.rng)
        base = s.detect_bbox if self.use_detections else s.bbox_visib
        return geometry.padding_bbox(base, self.padding_ratio)

    def _sample_dict(self, s: Sample, image, mask_visib, mask_full, bbox,
                     valid: float, im_w: int, im_h: int) -> Dict[str, np.ndarray]:
        p3d = self.p3d_table[s.obj_id] if self.p3d_table else self.p3d
        proj_xy, _ = geometry.project_pts(p3d, s.cam_K, s.R, s.t)
        final = geometry.final_bbox(bbox, self.resize_method, im_w, im_h)
        return {
            "image": image, "mask_visib": mask_visib, "mask_full": mask_full,
            "R": s.R.astype(np.float32), "t": s.t.astype(np.float32),
            "bbox": final.astype(np.float32),
            "cam_K": s.cam_K.astype(np.float32),
            "proj_xy": proj_xy.astype(np.float32),
            "obj_id": np.int32(s.obj_id), "obj_idx": self._obj_idx(s),
            "scene_id": np.int32(s.scene_id), "im_id": np.int32(s.im_id),
            "valid": np.float32(valid),
        }

    def _read_sample(self, s: Sample):
        """(rgb, mask_visib, mask_full) from the frame cache when present,
        else decoded from the files; an lm_imgn sample (a depth_path, no mask
        files) takes both masks from depth > 0 (the reference's
        lm_dataset_pytorch.py:368-371). None when any of them is unreadable."""
        img = mask_visib = mask_full = None
        if self.frame_cache is not None:
            img = self.frame_cache.get_frame(s.rgb_path)
            if s.mask_visib_path:
                mask_visib = self.frame_cache.get_mask(s.mask_visib_path)
                mask_full = self.frame_cache.get_mask(s.mask_path)
        if img is None:
            img = read_image(s.rgb_path)
        if mask_visib is None and s.depth_path:
            depth = read_depth_png(s.depth_path)
            if depth is not None:
                mask_visib = (depth > 0).astype(np.uint8) * 255
                mask_full = mask_visib.copy()
        if mask_visib is None:
            mask_visib = read_image(s.mask_visib_path, gray=True)
        if mask_full is None:
            mask_full = read_image(s.mask_path, gray=True)
        if img is None or mask_visib is None or mask_full is None:
            return None
        return img, mask_visib, mask_full

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        s = self.samples[index]
        if self.use_detections and s.detect_bbox is None:
            return self.dummy_item(s)
        if self.use_native and not s.depth_path:
            bbox = self._choose_bbox(s)
            try:
                return self._native_item(s, bbox)
            except OSError as e:
                print(f"native loader: {e}; reading {s.rgb_path} in python", flush=True)
            return self._python_item(s, bbox)
        return self._python_item(s)

    def _python_item(self, s: Sample, bbox=None) -> Dict[str, np.ndarray]:
        """The item through the python decode and crop; `bbox` when already
        drawn."""
        decoded = self._read_sample(s)
        if decoded is None:
            print(f"cannot load sample {s.rgb_path}", flush=True)
            return self.dummy_item(s)
        img, mask_visib, mask_full = decoded
        # draws from self.rng in the JAX package's order: the swap's coin
        # (real samples only), its background, then the bbox jitter
        bg_path = None
        if self.is_train and self.bg_paths and (
                s.img_type == "syn" or self.rng.random() < self.change_bg_prob):
            bg_path = self.bg_paths[int(self.rng.integers(len(self.bg_paths)))]
        if bbox is None:
            bbox = self._choose_bbox(s)
        if bg_path is not None:
            img = self._replace_bg(img, mask_full, bg_path, bbox)
        roi_img = get_roi_np(img, bbox, self.crop_size_img, "linear", self.resize_method)
        roi_mv = get_roi_np(mask_visib, bbox, self.crop_size_gt, "nearest", self.resize_method)
        roi_mf = get_roi_np(mask_full, bbox, self.crop_size_gt, "nearest", self.resize_method)
        return self._sample_dict(
            s, np.ascontiguousarray(roi_img),               # uint8 HWC
            roi_mv.astype(np.float32) / 255.0,
            roi_mf.astype(np.float32) / 255.0,
            bbox, 1.0, img.shape[1], img.shape[0])

    def _native_item(self, s: Sample, bbox) -> Dict[str, np.ndarray]:
        """One C++ call: decode, square crop and resize (cv2's geometry,
        native/loadercore.cpp); raises OSError when a file does not decode."""
        img, mf, mv, (w, h) = native_loader.load_sample(
            s.rgb_path, s.mask_path, s.mask_visib_path, bbox, self.crop_size_img,
            self.crop_size_gt)
        return self._sample_dict(s, img, mv, mf, bbox, 1.0, w, h)

    def supports_batch(self) -> bool:
        """True when `get_batch` can assemble whole batches in one native
        call. That call reports no image sizes, so only the square resize
        methods qualify (their final bbox ignores them)."""
        return self.use_native and self.resize_method in _SQUARE_METHODS

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        """The stacked items of `indices`, the native ones decoded and
        cropped in one call over the core's thread pool. Missing detections
        give dummy items, lm_imgn samples take the python path; a sample
        the core fails on is zero-filled and comes out with valid = 0 (its
        visible mask is empty, which a real sample's never is: the manifest
        filters on the visible fraction). The random draws go in the JAX
        package's order: the python items first, then the native items'
        bboxes."""
        if not self.supports_batch():
            raise ValueError("get_batch needs the native core and a square resize method "
                             "(the batch call reports no image sizes, which "
                             f"{self.resize_method!r} needs for its final bbox)")
        items: List[Optional[Dict[str, np.ndarray]]] = [None] * len(indices)
        native = []
        for i, j in enumerate(indices):
            s = self.samples[int(j)]
            if self.use_detections and s.detect_bbox is None:
                items[i] = self.dummy_item(s)
            elif s.depth_path:
                items[i] = self._python_item(s)
            else:
                native.append((i, s))
        if native:
            bboxes = np.stack([self._choose_bbox(s) for _, s in native])
            imgs, mf, mv, n_fail = native_loader.load_batch(
                [s.rgb_path for _, s in native], [s.mask_path for _, s in native],
                [s.mask_visib_path for _, s in native], bboxes, self.crop_size_img,
                self.crop_size_gt)
            if n_fail:
                print(f"native loader: {n_fail} failed decodes zero-filled", flush=True)
            for n, (i, s) in enumerate(native):
                b = bboxes[n]
                # a placeholder image size: the square methods' final bbox ignores it
                items[i] = self._sample_dict(s, imgs[n], mv[n], mf[n], b,
                                             1.0 if mv[n].max() > 0 else 0.0,
                                             int(b[0] + b[2] + 1), int(b[1] + b[3] + 1))
        return _stack(items)

    def _replace_bg(self, img, mask_full, bg_path: str, bbox):
        """img with the pixels outside the full mask (<= 127) taken from the
        background at bg_path resized to the frame bilinearly; img itself
        when the background does not read. Only the window the crop of bbox
        reads is resized and replaced (`ops/crop.py::roi_window`), which
        gives the crop of a whole-frame swap at a fraction of the cost."""
        bg = read_image(bg_path)
        if bg is None:
            return img
        h, w = img.shape[:2]
        y0, y1, x0, x1 = roi_window(bbox, self.resize_method, h, w)
        out = img.copy()
        if y1 <= y0 or x1 <= x0:
            return out
        win = resize_linear_u8(bg, h, w, rows=(y0, y1), cols=(x0, x1))
        region = out[y0:y1, x0:x1]
        keep_bg = mask_full[y0:y1, x0:x1] <= 127
        region[keep_bg] = win[keep_bg]
        return out


_SQUARE_METHODS = ("crop_square_resize", "crop_resize_by_warp_affine")


def _stack(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class Loader:
    """Infinite shuffled (train) or single-pass (eval) batch iterator with
    background-thread prefetch. A short last batch is padded by repeating
    the order from its start; `n_real` says how many rows are real. A
    dataset whose `supports_batch()` is true assembles each batch itself
    (`get_batch`)."""

    def __init__(self, dataset: CropDataset, batch_size: int, *, shuffle: bool,
                 drop_last: bool = True, prefetch: int = 4, seed: int = 0,
                 infinite: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.infinite = infinite
        self.rng = np.random.default_rng(seed)

    def _index_stream(self):
        n = len(self.ds)
        while True:
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(0, n, self.batch_size):
                chunk = order[i:i + self.batch_size]
                n_real = len(chunk)
                if n_real < self.batch_size:
                    if self.drop_last:
                        break
                    pad = np.resize(order, self.batch_size - n_real)
                    chunk = np.concatenate([chunk, pad])
                yield chunk, n_real
            if not self.infinite:
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        supports_batch = getattr(self.ds, "supports_batch", None)
        use_batch_api = supports_batch is not None and supports_batch()

        def worker():
            # an exception goes to the consumer; a thread that died silently
            # would leave q.get() waiting forever
            try:
                for chunk, n_real in self._index_stream():
                    if use_batch_api:
                        batch = self.ds.get_batch(chunk)
                    else:
                        batch = _stack([self.ds[int(j)] for j in chunk])
                    batch["n_real"] = np.int32(n_real)
                    q.put(batch)
                q.put(stop)
            except Exception as e:  # noqa: BLE001 -- re-raised by the consumer
                q.put(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            batch = q.get()
            if batch is stop:
                return
            if isinstance(batch, Exception):
                raise batch
            yield batch


def mixed_batch_sizes(batch_size: int, second_dataset_ratio: float):
    """Split a global batch across two datasets: batch2 = round(batch * ratio)."""
    b2 = int(round(batch_size * second_dataset_ratio))
    return batch_size - b2, b2


class MixedLoader:
    """Concatenates fixed-ratio sub-batches from two loaders per step."""

    def __init__(self, loader1: Loader, loader2: Loader):
        self.loader1 = loader1
        self.loader2 = loader2

    def __iter__(self):
        it1, it2 = iter(self.loader1), iter(self.loader2)
        while True:
            b1 = next(it1, None)
            b2 = next(it2, None)
            if b1 is None or b2 is None:
                return
            out = {k: np.concatenate([b1[k], b2[k]]) for k in b1 if k != "n_real"}
            out["n_real"] = b1["n_real"] + b2["n_real"]
            yield out
