"""BOP dataset object metadata: name<->id maps and symmetric-object sets
(the port's copy of checkerpose_tpu/data/dataset_info.py).

Factual tables of the BOP benchmark datasets (same data the reference ships in
`tools_for_BOP/common_dataset_info.py`).
"""
from __future__ import annotations

LM_OBJECTS = [
    "ape", "benchvise", "bowl", "cam", "can", "cat", "cup", "driller", "duck",
    "eggbox", "glue", "holepuncher", "iron", "lamp", "phone",
]

lmo_obj_name_obj_id = {name: i + 1 for i, name in enumerate(LM_OBJECTS)}
lmo_symmetry_obj = {"eggbox", "glue", "cup", "bowl"}

# the 13 objects used in the Linemod 13-object benchmark (bowl/cup excluded)
LM13_OBJECTS = [n for n in LM_OBJECTS if n not in ("bowl", "cup")]

YCBV_OBJECTS = [
    "master_chef_can", "cracker_box", "sugar_box", "tomato_soup_can",
    "mustard_bottle", "tuna_fish_can", "pudding_box", "gelatin_box",
    "potted_meat_can", "banana", "pitcher_base", "bleach_cleanser", "bowl",
    "mug", "power_drill", "wood_block", "scissors", "large_marker",
    "large_clamp", "extra_large_clamp", "foam_brick",
]
ycbv_obj_name_obj_id = {name: i + 1 for i, name in enumerate(YCBV_OBJECTS)}
ycbv_symmetry_obj = {"bowl", "wood_block", "large_clamp", "extra_large_clamp",
                     "foam_brick"}

tless_obj_name_obj_id = {f"obj{i:02d}": i for i in range(1, 31)}
tless_symmetry_obj = set(tless_obj_name_obj_id)

tudl_obj_name_obj_id = {f"obj{i:02d}": i for i in range(1, 4)}
tudl_symmetry_obj: set = set()

_TABLES = {
    "lm": (lmo_obj_name_obj_id, lmo_symmetry_obj),
    "lmo": (lmo_obj_name_obj_id, lmo_symmetry_obj),
    "ycbv": (ycbv_obj_name_obj_id, ycbv_symmetry_obj),
    "tless": (tless_obj_name_obj_id, tless_symmetry_obj),
    "tudl": (tudl_obj_name_obj_id, tudl_symmetry_obj),
    # test fixture / synthetic-proof dataset (multi-object LM-style proofs
    # use obj01..obj04; single-object fixtures only touch obj01/obj02)
    "synth": ({f"obj{i:02d}": i for i in range(1, 5)}, set()),
}


def get_obj_info(dataset_name: str):
    """(name -> obj_id map, symmetric-name set). Mirrors reference
    `common_dataset_info.get_obj_info` (`tools_for_BOP/common_dataset_info.py:112`)."""
    if dataset_name not in _TABLES:
        raise ValueError(f"dataset name unknown: {dataset_name}")
    return _TABLES[dataset_name]
