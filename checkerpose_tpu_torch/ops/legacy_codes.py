"""Legacy ZebraPose correspondence-dict utilities (the port's own copy of
checkerpose_tpu/ops/legacy_codes.py).

The reference keeps a vestigial tool that coarsens 16-bit ZebraPose class-id
-> 3D-point dicts by averaging the children of each coarser cell
(`binary_code_helper/generate_new_dict.py:4-33`); kept for data
compatibility with ZebraPose-era files.
"""
from __future__ import annotations

import numpy as np


def coarsen_corres_dict(dict_16bit: dict, new_bits: int) -> dict:
    """{id16: (3,) point} -> {id_new: mean of its 2**(16 - new_bits) children}."""
    if not 0 < new_bits <= 16:
        raise ValueError(f"new_bits must lie in [1, 16], got {new_bits}")
    shift = 16 - new_bits
    acc, cnt = {}, {}
    for cid, pt in dict_16bit.items():
        nid = int(cid) >> shift
        acc[nid] = acc.get(nid, np.zeros(3)) + np.asarray(pt, np.float64)
        cnt[nid] = cnt.get(nid, 0) + 1
    return {nid: acc[nid] / cnt[nid] for nid in acc}


def load_corres_dict(path: str):
    """Parse a ZebraPose class-id -> 3D-point txt dict: a header line
    `total_classes divide_per_iter n_iters`, then one `class_id x y z` line
    an entry (the reference's `binary_code_helper/CNN_output_to_pose.py:6-28`).
    Returns (total_classes, divide_per_iter, n_iters, {int id: (3,) float64}):
    ids are ints (the reference keeps them as floats), values mm-scale model
    points."""
    table = {}
    with open(path, "r") as f:
        header = f.readline().split()
        if len(header) != 3:
            raise ValueError(f"bad legacy dict header in {path!r}: {header}")
        total_classes, divide_per_iter, n_iters = (float(v) for v in header)
        for ln, line in enumerate(f, start=2):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 4:
                raise ValueError(f"{path}:{ln}: expected 'id x y z', got {line!r}")
            cid, x, y, z = (float(v) for v in parts)
            table[int(cid)] = np.array([x, y, z], np.float64)
    return total_classes, divide_per_iter, n_iters, table
