"""The frozen reference against the measured program at small widths on the
CPU (both in float32), and the model operations it counts."""
import time

import numpy as np
import pytest
import torch

from posebench import flops, harness, inputs, weights
from posebench.loops import common
from posebench.reference import model as ref
from posebench.tests.tiny import TINY_MODEL, tiny_cell

SMALL = dict(TINY_MODEL, npoint=32)


def _config(backbone):
    cfg = harness.load_cell("hr18_lmo.serve_b512").config
    cfg["model"].update(SMALL, backbone=backbone)
    cfg["dtype"] = "float32"
    return cfg


@pytest.mark.parametrize("backbone", ["hrnet_w18", "resnet34"])
def test_weights_load_into_both_sides(backbone):
    cfg = _config(backbone)
    state = weights.make_state_dict(cfg["model"], 3, "cpu")
    prog = common.program_net(cfg, state, torch.device("cpu"))
    assert set(prog.state_dict()) == set(state)
    assert set(ref.build(cfg["model"]).state_dict()) == set(state)


@pytest.mark.parametrize("backbone,per_sample", [("hrnet_w18", False), ("resnet34", True)])
def test_reference_forward_matches_the_program_in_float32(backbone, per_sample):
    torch.manual_seed(0)
    cfg = _config(backbone)
    state = weights.make_state_dict(cfg["model"], 5, "cpu")
    prog = common.program_net(cfg, state, torch.device("cpu"))
    refnet = common.reference_net(cfg, state, torch.device("cpu"))
    _, _, knn = inputs.keypoints(np.random.default_rng(1), 2, SMALL["npoint"], 4)
    imgs = inputs.normalize_image(inputs.device_crops(7, 2, "cpu"))
    knn = torch.as_tensor(knn) if per_sample else torch.as_tensor(knn[0])
    with torch.no_grad():
        a = prog(imgs, knn)
        b = refnet(imgs, knn)
        c = refnet(imgs, knn, forced={"x_id": a["x_id"], "y_id": a["y_id"],
                                      "roi": a["roi_logit"][..., 0] > 0})
    for k in ("x_logits", "y_logits", "seg_logits"):
        torch.testing.assert_close(a[k], b[k], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a[k], c[k], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(a["roi_logit"][..., 0], b["roi_logit"], atol=1e-4, rtol=1e-4)
    assert torch.equal(a["x_id"].long(), b["x_id"]) and torch.equal(a["y_id"].long(), b["y_id"])


def test_reference_training_step_matches_the_program_in_float32():
    from posebench.loops import train
    cell = tiny_cell("hr18_lmo.train_b128")
    cell.config["dtype"] = "float32"
    ctx = harness.Context(cell, 9, 0.2, False, torch.device("cpu"), time.perf_counter())
    d = train.Loop(ctx)
    d.setup()
    d.check()
    assert abs(d.losses[0] - d.ref_run[0][0]) <= 1e-5 * abs(d.ref_run[0][0])
    assert d.numbers["grad_norm_gap"] < 1e-4
    assert d.numbers["change_norm_gap_median"] < 1e-2
    assert d.numbers["logit_err_p50"] < 1e-4


def test_forced_forward_gathers_at_the_given_cells():
    cfg = _config("hrnet_w18")
    refnet = common.reference_net(cfg, weights.make_state_dict(cfg["model"], 2, "cpu"), "cpu")
    _, _, knn = inputs.keypoints(np.random.default_rng(2), 1, SMALL["npoint"], 4)
    imgs = inputs.normalize_image(inputs.device_crops(8, 2, "cpu"))
    knn = torch.as_tensor(knn[0])
    with torch.no_grad():
        free = refnet(imgs, knn)
        every = torch.ones_like(free["roi_logit"], dtype=torch.bool)
        own = refnet(imgs, knn, forced={"x_id": free["x_id"], "y_id": free["y_id"],
                                        "roi": every})
        moved = refnet(imgs, knn, forced={"x_id": 63 - free["x_id"], "y_id": free["y_id"],
                                          "roi": every})
    assert torch.equal(own["x_logits"][..., :3], moved["x_logits"][..., :3])
    assert not torch.equal(own["x_logits"][..., 3:], moved["x_logits"][..., 3:])


@pytest.mark.parametrize("config,per_sample,gflop", [("hr18_lmo", False, 32.17),
                                                      ("res34_lm", True, 28.83)])
def test_model_operations_a_crop(config, per_sample, gflop):
    cell = {"hr18_lmo": "hr18_lmo.serve_b512", "res34_lm": "res34_lm.eval_b512"}[config]
    model = harness.load_cell(cell).config["model"]
    assert round(flops.forward_flops(model, per_sample) / 1e9, 2) == gflop


def test_parameters_as_published():
    assert round(weights.param_count(harness.load_cell("hr18_lmo.serve_b512")
                                     .config["model"]) / 1e6, 1) == 21.3
    assert round(weights.param_count(harness.load_cell("res34_lm.eval_b512")
                                     .config["model"]) / 1e6, 1) == 29.3
