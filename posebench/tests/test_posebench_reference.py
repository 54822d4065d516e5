"""The frozen reference against the measured program at small widths on the
CPU (both in float32), the model operations it counts, its weights, and its
backbones found by file."""
import hashlib
import sys
import time

import numpy as np
import pytest
import torch

from posebench import flops, harness, inputs, weights
from posebench.loops import common
from posebench.reference import backbones
from posebench.reference import model as ref
from posebench.tests.tiny import TINY_MODEL, tiny_cell

SMALL = dict(TINY_MODEL, npoint=32)

# sha256 of make_state_dict(model, 7, "cpu") (each entry's name, shape and
# float32 bytes, in order), recorded before the backbones moved to files of
# their own: every cell's weights stay what they were
STATE_DIGESTS = {
    "hr18_lmo.serve_b512": "3957d047cabd6aa25862d18405b7fadc51586f9375812f3145ad5fab900dc02a",
    "res34_lm.eval_b512": "26ddbe29faa237606f58bca7d4b85242ccade31ed969f98b3db6001a15c631bf",
}

# a backbone brought by a file of its own: patch convolutions and a channel
# norm whose scale the module declares
THROWAWAY = """
import torch
import torch.nn as nn

from posebench.reference.model import Conv2d

DIMS = (8, 16, 24, 32)


class ChannelNorm(nn.Module):
    draws = {"weight": (0.9, 1.1)}

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = x.var(1, keepdim=True, unbiased=False)
        return ((x - mu) * torch.rsqrt(var + 1e-6) * self.weight[:, None, None]
                + self.bias[:, None, None])


class Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, (c, s) in enumerate(zip(DIMS, (4, 2, 2, 2))):
            self.add_module(f"down{i}", Conv2d(cin, c, s, s))
            self.add_module(f"norm{i}", ChannelNorm(c))
            cin = c

    def forward(self, x):
        feats = []
        for i in range(len(DIMS)):
            x = getattr(self, f"norm{i}")(getattr(self, f"down{i}")(x))
            feats.append(x)
        return feats
"""


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


def _float32_training(workload):
    """The tiny cell's checked steps in float32 on both sides."""
    from posebench.loops import train
    cell = tiny_cell(workload)
    cell.config["dtype"] = "float32"
    ctx = harness.Context(cell, 9, 0.2, False, torch.device("cpu"), time.perf_counter())
    d = train.Loop(ctx)
    d.setup()
    d.check()
    assert abs(d.losses[0] - d.ref_run[0][0]) <= 1e-5 * abs(d.ref_run[0][0])
    assert d.numbers["grad_norm_gap"] < 1e-4
    assert d.numbers["change_norm_gap_median"] < 1e-2
    assert d.numbers["logit_err_p50"] < 1e-4
    return d


def test_reference_training_step_matches_the_program_in_float32():
    d = _float32_training("hr18_lmo.train_b128")
    assert d.graph(0).dim() == 2 and "obj_idx" not in d.pool[0]


def test_reference_training_step_matches_the_program_on_a_per_sample_graph():
    d = _float32_training("res34_lm.train_b32")
    for i, batch in enumerate(d.pool):
        obj = batch["obj_idx"]
        assert len(set(obj.tolist())) > 1                      # batches mix objects
        assert torch.equal(d.graph(i), d.knn[obj])             # each sample its rows


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


@pytest.mark.parametrize("config,gflop", [("hr18_lmo", 96.19), ("res34_lm", 86.18)])
def test_model_operations_a_training_image(config, gflop):
    cell = {"hr18_lmo": "hr18_lmo.train_b128", "res34_lm": "res34_lm.train_b32"}[config]
    model = harness.load_cell(cell).config["model"]
    assert round(flops.train_flops(model) / 1e9, 2) == gflop


@pytest.mark.parametrize("workload", sorted(STATE_DIGESTS))
def test_weights_are_those_drawn_before_the_backbones_moved(workload):
    h = hashlib.sha256()
    state = weights.make_state_dict(harness.load_cell(workload).config["model"], 7, "cpu")
    for name, t in state.items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == STATE_DIGESTS[workload]


def test_an_unknown_backbone_names_the_file_it_looked_for():
    cfg = _config("hrnet_w18")["model"]
    with pytest.raises(ValueError, match=r"backbones/no_such_net\.py"):
        ref.build(dict(cfg, backbone="no_such_net"))


def test_a_backbone_file_brings_a_new_backbone_and_its_draws(tmp_path, monkeypatch):
    (tmp_path / "throwaway_norm.py").write_text(THROWAWAY)
    monkeypatch.setattr(backbones, "__path__", [*backbones.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "posebench.reference.backbones.throwaway_norm",
                        raising=False)
    cfg = _config("throwaway_norm")["model"]
    net = ref.build(cfg)
    state = weights.make_state_dict(cfg, 3, "cpu")
    assert set(state) == set(net.state_dict())
    for i in range(4):
        scale = state[f"init_net.backbone.norm{i}.weight"]
        assert 0.9 <= float(scale.min()) and float(scale.max()) <= 1.1      # as declared
        assert float(state[f"init_net.backbone.norm{i}.bias"].abs().max()) <= 0.05
    assert float(state["init_net.backbone.down0.weight"].std()) > 0.1      # lecun, fan-in 48
    assert weights.param_count(cfg) == sum(p.numel() for p in net.parameters())
    assert flops.forward_flops(cfg) > 0
    net.load_state_dict(state)
    _, _, knn = inputs.keypoints(np.random.default_rng(3), 1, SMALL["npoint"], 4)
    with torch.no_grad():
        out = net(inputs.normalize_image(inputs.device_crops(4, 1, "cpu")),
                  torch.as_tensor(knn[0]))
    assert out["x_logits"].shape == (1, SMALL["npoint"], 6)
    assert torch.isfinite(out["seg_logits"]).all()
