"""Detector-output ingest (the port's copy of
checkerpose_tpu/data/detections.py).

The reference consumes FCOS detection JSONs keyed `"scene_id/im_id"` with
entries `{obj_id, bbox_est [x,y,w,h], score, time}` and keeps the
best-scoring bbox per (image, object) (`get_detection_results.py:4-34`).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from checkerpose_tpu_torch.data.bop_io import Sample


def load_detections(path: str, obj_id: int) -> Dict[Tuple[int, int], Tuple[np.ndarray, float]]:
    """{(scene_id, im_id): (bbox xywh, score)} keeping only the best score
    per image for `obj_id`."""
    with open(path, "r") as f:
        raw = json.load(f)
    best: Dict[Tuple[int, int], Tuple[np.ndarray, float]] = {}
    for key, dets in raw.items():
        scene_s, im_s = key.split("/")
        k = (int(scene_s), int(im_s))
        for det in dets:
            if int(det["obj_id"]) != obj_id:
                continue
            score = float(det.get("score", 0.0))
            if k not in best or score > best[k][1]:
                best[k] = (np.array(det["bbox_est"], np.float64), score)
    return best


def attach_detections(samples: List[Sample], detections) -> List[Sample]:
    """Fill each sample's detect_bbox from the detection table; samples with
    no detection keep detect_bbox=None (the dataset emits a dummy input for
    them, mirroring `bop_dataset_pytorch.py:325-338`)."""
    for s in samples:
        hit = detections.get((s.scene_id, s.im_id))
        if hit is not None:
            s.detect_bbox, s.detect_score = hit[0], hit[1]
        else:
            s.detect_bbox, s.detect_score = None, -1.0
    return samples


def ycbv_select_keyframe(detections, samples: List[Sample]) -> List[Sample]:
    """Keep only YCB-Video keyframe images (scene/image pairs present in the
    detection file), the reference's `ycbv_select_keyframe`
    (`get_detection_results.py:133-150`)."""
    keys = set(detections.keys())
    return [s for s in samples if (s.scene_id, s.im_id) in keys]


def detection_scores(detections, samples: List[Sample]) -> List[float]:
    """Best score per sample, -1 when the detector missed (reference
    `get_detection_scores`, `get_detection_results.py:66-131`)."""
    return [detections.get((s.scene_id, s.im_id), (None, -1.0))[1]
            for s in samples]
