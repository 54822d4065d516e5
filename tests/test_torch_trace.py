"""The port's spans (utils/logging.py::span) on the CPU at tiny sizes.

Off (no profiler recording) a span records nothing and opens no profiler
range. On or off, the serving call and stream, the eval sweep (with and
without its synchronised `spans=` dict) and a train step give the same
bits. Under `profiler(dir)`, trace.json holds every span of the path with
its nesting and count, and spans.json its count and host ms per name, with
device ms null without a card."""
import json

import numpy as np
import pytest
import torch

from checkerpose_tpu_torch.eval.harness import evaluate_pipeline
from checkerpose_tpu_torch.models.posenet import make_posenet
from checkerpose_tpu_torch.ops.knn import knn_index
from checkerpose_tpu_torch.serving import ServingPipeline
from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer
from checkerpose_tpu_torch.train.steps import make_train_step
from checkerpose_tpu_torch.utils import logging as plog
from torch_parity import few_torch_threads  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, B, STAGES = 16, 2, 3
CFG = dict(npoint=NPT, res_log2=3 + STAGES, backbone_name="hrnet_w18_small",
           num_graph_module=1, init_num_graph_module=1, dtype=torch.float32)
K = np.array([[572.4, 0, 128.0], [0, 573.6, 128.0], [0, 0, 1]], np.float32)

POSENET = {"posenet.backbone": "posenet", "posenet.init_head": "posenet",
           "posenet.stage": "posenet", "posenet.seg": "posenet"}
SOLVER = {"solver.hypotheses": "solver", "solver.refine": "solver"}
# each path's spans: name -> (the span around it, count)
SERVING_CALLS, STREAM_BATCHES = 1, 3
N_SERVE = SERVING_CALLS + STREAM_BATCHES
EVAL_BATCHES = 2
NESTING = {
    "serving": dict(
        {"serving.call": (None, N_SERVE), "posenet": ("serving.call", N_SERVE),
         "decode": ("serving.call", N_SERVE), "solver": ("serving.call", N_SERVE),
         "serving.to_host": (None, STREAM_BATCHES)},
        **{k: (v, N_SERVE * (STAGES if k == "posenet.stage" else 1))
           for k, v in POSENET.items()},
        **{k: (v, N_SERVE) for k, v in SOLVER.items()}),
    "eval": dict(
        {"eval.loader": (None, EVAL_BATCHES + 1), "eval.batch": (None, EVAL_BATCHES),
         "eval.forward_decode": ("eval.batch", EVAL_BATCHES),
         "eval.solver_metrics": ("eval.batch", EVAL_BATCHES),
         "eval.aggregate": ("eval.batch", EVAL_BATCHES),
         "posenet": ("eval.forward_decode", EVAL_BATCHES),
         "decode": ("eval.forward_decode", EVAL_BATCHES),
         "solver": ("eval.solver_metrics", EVAL_BATCHES)},
        **{k: (v, EVAL_BATCHES * (STAGES if k == "posenet.stage" else 1))
           for k, v in POSENET.items()},
        **{k: (v, EVAL_BATCHES) for k, v in SOLVER.items()}),
    "train": dict(
        {"train.step": (None, 1), "train.augment": ("train.step", 1),
         "train.forward": ("train.step", 1), "posenet": ("train.forward", 1),
         "train.backward": ("train.step", 1), "train.optimizer": ("train.step", 1)},
        **{k: (v, STAGES if k == "posenet.stage" else 1) for k, v in POSENET.items()}),
}
NESTING["eval_spans"] = NESTING["eval"]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    p3d = rng.uniform(-40, 40, (NPT, 3)).astype(np.float32)
    p3dn = (p3d / np.abs(p3d).max()).astype(np.float32)
    knn = knn_index(p3dn, 5)
    images = rng.integers(0, 255, (B, 256, 256, 3)).astype(np.uint8)
    bbox = np.tile(np.array([[50., 60., 130., 130.]], np.float32), (B, 1))
    proj = np.stack([rng.uniform(60, 170, (B, NPT)), rng.uniform(70, 180, (B, NPT))], -1)
    masks = (rng.random((2, B, 64, 64)) > 0.4).astype(np.float32)
    return dict(p3d=p3d, p3dn=p3dn, knn=knn, images=images, bbox=bbox,
                proj=proj.astype(np.float32), masks=masks)


def _serving(s):
    net = make_posenet(device="cpu", seed=1, **CFG)
    pipe = ServingPipeline(net, s["knn"], s["p3d"], s["p3dn"], device="cpu")
    gen = torch.Generator().manual_seed(5)
    out = {k: v.numpy() for k, v in pipe(s["images"], s["bbox"], K, gen).items()}
    batches = [(s["images"][::(-1) ** i].copy(), s["bbox"] + i, K)
               for i in range(STREAM_BATCHES)]
    streamed = list(pipe.stream(batches, gen, depth=2))
    return [out] + streamed


def _eval(s, spans=None):
    net = make_posenet(device="cpu", seed=2, **CFG)
    batches = []
    for i in range(EVAL_BATCHES):
        batches.append({
            "image": s["images"][::(-1) ** i].copy(), "bbox": s["bbox"],
            "p3d_normed": np.broadcast_to(s["p3dn"], (B, NPT, 3)).copy(),
            "R": np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy(),
            "t": np.tile(np.array([[0., 0., 600.]], np.float32), (B, 1)),
            "cam_K": np.broadcast_to(K, (B, 3, 3)).copy(), "proj_xy": s["proj"],
            "mask_visib": s["masks"][0], "valid": np.ones(B, np.float32), "n_real": B,
            "scene_id": np.zeros(B, np.int32), "im_id": np.arange(B, dtype=np.int32) + B * i})
    return evaluate_pipeline(net, s["knn"], batches, s["p3d"], 80.0, stage=STAGES, seed=7,
                             spans=spans)


def _train(s):
    net = make_posenet(device="cpu", seed=3, **CFG)
    state = create_pose_state(net, make_optimizer(1e-3), seed=None, device="cpu")
    step = make_train_step(net, torch.as_tensor(s["knn"]), STAGES)
    batch = {"image": torch.as_tensor(s["images"]), "proj_xy": torch.as_tensor(s["proj"]),
             "bbox": torch.as_tensor(s["bbox"]), "mask_visib": torch.as_tensor(s["masks"][0]),
             "mask_full": torch.as_tensor(s["masks"][1]),
             "p3d_normed": torch.as_tensor(s["p3dn"]).expand(B, NPT, 3)}
    metrics = step(state, batch, torch.Generator().manual_seed(11))
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "params": {k: v.detach().numpy().copy() for k, v in net.state_dict().items()},
            "adam": [v["exp_avg_sq"].numpy().copy()
                     for v in state.optimizer.state.values()]}


def _run(path, s):
    if path == "serving":
        return _serving(s)
    if path == "train":
        return _train(s)
    if path == "eval":
        return _eval(s)
    spans = {}
    return _eval(s, spans), sorted((k, len(v)) for k, v in spans.items())


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Each path once with the spans off and once under profiler(dir):
    {path: (output off, output on, dir)}, computed on first use."""
    done = {}

    def get(path):
        if path not in done:
            off = _run(path, scene)
            d = tmp_path_factory.mktemp(path)
            with plog.profiler(str(d)):
                on = _run(path, scene)
            done[path] = (off, on, d)
        return done[path]
    return get


def _same(a, b):
    """Exactly equal, recursively (NaN equal to NaN)."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic, float)):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def test_spans_are_off_without_the_profiler(scene, monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a profiler range was opened with the profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    before = len(plog.span_records())
    assert plog.span("posenet") is plog.span("solver")        # the shared no-op
    with plog.span("posenet", torch.device("cpu")):
        pass
    _serving(scene)
    assert len(plog.span_records()) == before


@pytest.mark.parametrize("path", ["serving", "eval", "eval_spans", "train"])
def test_outputs_are_the_same_bits_with_spans_on_and_off(runs, path):
    off, on, _ = runs(path)
    assert _same(off, on)


def _ranges(trace_dir):
    """(name, start, end, thread) of the port's spans in trace.json."""
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    names = {n for path in NESTING.values() for n in path}
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") in names]


def _parent(r, ranges):
    """The innermost of `ranges` around range r on its thread, or None."""
    around = [o for o in ranges if o is not r and o[3] == r[3]
              and o[1] <= r[1] and r[2] <= o[2] and (o[2] - o[1]) > (r[2] - r[1])]
    return min(around, key=lambda o: o[2] - o[1])[0] if around else None


@pytest.mark.parametrize("path", ["serving", "eval", "eval_spans", "train"])
def test_profiler_writes_each_span_with_its_nesting_and_count(runs, path):
    _, on, trace_dir = runs(path)
    expected = NESTING[path]
    ranges = _ranges(trace_dir)
    counts = {}
    for r in ranges:
        counts[r[0]] = counts.get(r[0], 0) + 1
        assert _parent(r, ranges) == expected[r[0]][0], r
    assert counts == {k: n for k, (_, n) in expected.items()}
    summary = json.loads((trace_dir / "spans.json").read_text())
    assert {k: v["count"] for k, v in summary.items()} == counts
    for name, v in summary.items():
        assert v["host_ms"] > 0 and v["device_ms"] is None, name
    assert plog.span_records() == []                  # the scope drained its records
    if path == "eval_spans":                          # the synchronised dict as before
        assert on[1] == [(k, EVAL_BATCHES) for k in
                         ("aggregate", "forward_decode", "loader", "solver_metrics")]


def test_records_name_their_parent_and_resolve_without_a_card(scene):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _train(scene)
    records = plog.drain_spans()
    resolved = plog.resolve_spans(records)
    assert [r["name"] for r in resolved] == [r.name for r in records]
    expected = NESTING["train"]
    # a record's parent: the innermost other record whose host interval holds it
    ranges = [(r.name, r.host_start, r.host_end, 0) for r in records]
    for r, res in zip(ranges, resolved):
        assert _parent(r, ranges) == expected[r[0]][0], r
        assert res["host_ms"] > 0 and res["device_ms"] is None
    summary = plog.span_summary(records)
    assert summary["posenet.stage"]["count"] == STAGES
    assert summary["train.step"]["host_ms"] >= summary["train.backward"]["host_ms"]
