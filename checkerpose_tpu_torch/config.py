"""Config system: flat `key = value` .txt files, reference-compatible (the
port's copy of checkerpose_tpu/config.py).

Grammar and type-coercion rules match the reference parser
(`checkerpose/config_parser.py:1-39`) so the shipped config presets under
`config/{lm,lmo}/*.txt` parse identically:
  * lines starting with '#' or blank are skipped
  * `type` is renamed `_type`
  * keys ending in `_weight` and a whitelist of slope/dropout keys -> float
  * numeric-looking values -> int
  * keys starting with `learning_rate` and a second whitelist -> float
  * literal True/False -> bool
"""
from __future__ import annotations

from typing import Any, Dict

_FLOAT_KEYS = {
    "train_with_gt_codes_dropout", "auto_gt_codes_dropout_bias",
    "network_leaky_slope", "network_graph_leaky_slope",
    "init_network_graph_leaky_slope", "conf_factor_tau",
    "conf_network_leaky_slope", "conf_network_graph_leaky_slope",
}

_LATE_FLOAT_KEYS = {
    "padding_ratio", "train_obj_visible_theshold",  # sic: reference typo kept
    "second_dataset_ratio", "vert_visib_ratio", "change_bg_prob",
}


def parse_cfg(cfgfile: str) -> Dict[str, Any]:
    block: Dict[str, Any] = {}
    with open(cfgfile, "r") as fp:
        for line in fp:
            line = line.rstrip()
            if line == "" or line[0] == "#":
                continue
            key, value = line.split("=", 1)
            key = key.strip()
            if key == "type":
                key = "_type"
            value: Any = value.strip()

            if key.lower().endswith("_weight") or key.lower() in _FLOAT_KEYS:
                value = float(value)
            elif isinstance(value, str) and value.isnumeric():
                value = int(value)

            if key.startswith("learning_rate") or key in _LATE_FLOAT_KEYS:
                value = float(value)

            if value == "False":
                value = False
            elif value == "True":
                value = True

            block[key] = value
    return block


def stage_start_steps(cfg: Dict[str, Any]):
    """Parse `stage_start_steps_str` like "0_0_0" -> (0, 0, 0).

    Equivalent of `common_ops.from_dim_str_to_tuple` usage at
    reference `train.py:76-80`.
    """
    s = cfg.get("stage_start_steps_str", None)
    if s is None:
        return None
    return tuple(int(x) for x in str(s).split("_"))


def get_train_stage(step: int, starts) -> int:
    """Progressive-curriculum stage for a global step.

    Mirrors reference `train.py:35-41`: stage = number of refine blocks whose
    start step has passed.
    """
    stage = 0
    for s in starts:
        if step >= s:
            stage += 1
    return stage
