"""The readers of the program's spans (metrics/_spans.py) over a hand-built
trace and hand-built span records: which instances they read (the traced
call's, inside the window), what they divide by, the idle overlap with a
span's host ranges (taken off its device ms), the host's waits on the device
(taken off its host ms), and None off the card or without span records."""
import types

import pytest
import torch

from posebench import harness
from posebench import trace as tr
from posebench.metrics import _spans

CUDA = torch.device("cuda", 0)
WINDOW = (10.0, 20.0)
BUSY = [("k", 9.0, 21.0)]               # the device busy all through the window


class FakeProgram:
    """The program's span module as the readers see it: records with a name
    and their device ms."""

    def __init__(self, records):
        self.records = [types.SimpleNamespace(name=n, device_ms=ms) for n, ms in records]

    def span_records(self):
        return list(self.records)

    def resolve_spans(self, records):
        return [{"name": r.name, "device_ms": r.device_ms} for r in records]


def _ctx(host_ops, device_ops=(), device=CUDA):
    host = [(tr.WINDOW, *WINDOW)] + list(host_ops)
    trace = tr.Trace(list(device_ops), host, WINDOW, units=2)
    return types.SimpleNamespace(device=device, trace=trace)


# the traced call: one batch of warm-up before the window, two inside, one
# drained after it; each batch a posenet with a backbone and 3 stages
BATCHES = [7.0, 11.0, 14.0, 21.0]


def _host_ops():
    ops = []
    for t0 in BATCHES:
        ops.append(("posenet", t0, t0 + 2.0))
        ops.append(("posenet.backbone", t0, t0 + 1.0))
        ops += [("posenet.stage", t0 + 1.0 + 0.3 * i, t0 + 1.3 + 0.3 * i) for i in range(3)]
        ops.append(("decode", t0 + 2.0, t0 + 2.25))
        ops.append(("solver", t0 + 2.25, t0 + 2.75))
    return ops


def _records():
    # an earlier profiled call's two batches come first: not the stretch's
    recs = [("posenet.backbone", 1000.0), ("posenet.stage", 1000.0)] * 2
    for i in range(len(BATCHES)):
        recs.append(("posenet.backbone", 10.0 * (i + 1)))
        recs += [("posenet.stage", 1.0 * (i + 1))] * 3
    return recs


@pytest.fixture
def program(monkeypatch):
    prog = FakeProgram(_records())
    monkeypatch.setattr(_spans, "_program", lambda: prog)
    return prog


def test_device_ms_reads_the_windows_instances_of_the_traced_call(program):
    ctx = _ctx(_host_ops(), BUSY)
    assert _spans.count(ctx, "posenet") == 2
    assert _spans.device_ms(ctx, "posenet.backbone") == [20.0, 30.0]
    assert _spans.device_ms_per(ctx, ["posenet.backbone"], "posenet") == 25.0
    # three stages a batch, summed a batch
    assert harness.reader("stages_dev_ms.pose")(ctx) is None        # no init head recorded
    assert _spans.device_ms_per(ctx, ["posenet.stage"], "posenet") == pytest.approx(7.5)
    assert harness.reader("backbone_dev_ms.pose")(ctx) == 25.0


def test_device_ms_leaves_out_the_idle_inside_the_host_range(program):
    # idle [11.25, 11.5) inside the first window batch's backbone [11, 12),
    # and [14.5, 15.5) across the second's backbone [14, 15) and two stages
    dev = [("k", 9.0, 11.25), ("k", 11.5, 14.5), ("k", 15.5, 21.0)]
    ctx = _ctx(_host_ops(), dev)
    assert _spans.device_ms(ctx, "posenet.backbone") == pytest.approx([20.0 - 250.0,
                                                                        30.0 - 500.0])
    assert _spans.device_ms(ctx, "posenet.stage") == pytest.approx([2.0, 2.0, 2.0,
                                                                     3.0 - 300.0, 3.0 - 200.0, 3.0])


def test_host_ms_comes_from_the_trace_and_counts_the_window_only(program):
    ctx = _ctx(_host_ops(), BUSY)
    # posenet 2 + decode 0.25 + solver 0.5 s a batch
    assert harness.reader("enqueue_ms.pose")(ctx) == pytest.approx(2750.0)


def test_host_ms_leaves_out_the_hosts_waits_on_the_device(program):
    # launches of 0.01 s (the usual cost) and one of 0.21 s in the first
    # window batch's posenet; a 0.2 s synchronisation in its solver, of which
    # the device ran the first 0.1 s only; a long cudaFree on an idle device
    calls = [("cudaLaunchKernel", 11.0 + 0.1 * i, 11.01 + 0.1 * i) for i in range(5)]
    calls += [("cudaLaunchKernel", 12.0, 12.21), ("cudaStreamSynchronize", 13.3, 13.5),
              ("cudaFree", 14.0, 14.5), ("aten::empty", 14.0, 14.5)]
    dev = [("k", 9.0, 13.4), ("k", 14.6, 21.0)]
    ctx = _ctx(_host_ops() + calls, dev)
    waits = _spans.waits(ctx)
    assert waits == pytest.approx([(12.01, 12.21), (13.3, 13.4)])
    assert harness.reader("enqueue_ms.pose")(ctx) == pytest.approx(2750.0 - 150.0)


def test_no_reading_off_the_card_or_without_records(program, monkeypatch):
    assert harness.reader("backbone_dev_ms.pose")(_ctx(_host_ops(), device=torch.device("cpu"))) \
        is None
    assert harness.reader("enqueue_ms.train")(_ctx(_host_ops())) is None    # no train.step
    assert harness.reader("backward_dev_ms.train")(_ctx(_host_ops())) is None
    monkeypatch.setattr(_spans, "_program", lambda: None)            # a program without spans
    assert harness.reader("backbone_dev_ms.pose")(_ctx(_host_ops())) is None
    # more host ranges than records: not the program's records
    monkeypatch.setattr(_spans, "_program", lambda: FakeProgram([("posenet.backbone", 1.0)]))
    assert harness.reader("backbone_dev_ms.pose")(_ctx(_host_ops())) is None


def test_solver_idle_is_the_idle_inside_the_solvers_host_ranges(program):
    # device busy over [10, 12.5) and [13.0, 16.5); idle [12.5, 13), [16.5, 20)
    dev = [("k", 9.0, 12.5), ("k", 13.0, 16.5)]
    ctx = _ctx(_host_ops(), dev)
    # solver host ranges in the window: [13.25, 13.75), [16.25, 16.75);
    # idle inside them: [16.5, 16.75) only
    share = harness.reader("solver_idle_share.pose")(ctx)
    assert share == pytest.approx(100.0 * 0.25 / 10.0)
    assert harness.reader("solver_idle_share.open")(ctx) == share
    assert share <= harness.reader("idle_share.pose")(ctx)
    assert harness.reader("solver_idle_share.pose")(_ctx(_host_ops())) is None  # no device op


def test_train_readers_divide_by_the_steps(monkeypatch):
    steps = [(8.0, 9.5), (11.0, 13.0), (13.5, 15.0)]        # warm-up, then two in the window
    host, recs = [], []
    for i, (s, e) in enumerate(steps):
        host += [("train.step", s, e), ("train.augment", s, s + 0.1),
                 ("train.forward", s + 0.1, s + 0.5), ("train.backward", s + 0.5, s + 1.0),
                 ("train.optimizer", s + 1.0, s + 1.2)]
        recs += [("train.step", 100.0), ("train.augment", 1.0 + i),
                 ("train.forward", 10.0 + i), ("train.backward", 20.0 + i),
                 ("train.optimizer", 5.0)]
    monkeypatch.setattr(_spans, "_program", lambda: FakeProgram(recs))
    ctx = _ctx(host, BUSY)
    assert harness.reader("forward_dev_ms.train")(ctx) == pytest.approx((2 + 11 + 3 + 12) / 2)
    assert harness.reader("backward_dev_ms.train")(ctx) == pytest.approx(21.5)
    assert harness.reader("optimizer_dev_ms.train")(ctx) == pytest.approx(5.0)
    assert harness.reader("enqueue_ms.train")(ctx) == pytest.approx(1e3 * (2.0 + 1.5) / 2)
