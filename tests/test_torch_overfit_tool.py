"""The port's overfit tool (checkerpose_tpu_torch/tools/diag_overfit.py)
and chip_smoke.py's phase trained on the CPU: the tool's fixture against
the JAX generator run with tools/gen_synth_scale.py's arguments, its
command line at a tiny size, and the phase rehearsed at a tiny size. The
training comparison with the JAX package is tests/test_torch_overfit.py."""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.tools import diag_overfit
from torch_parity import few_torch_threads  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def test_fixture_is_the_head_of_gen_synth_scale(tmp_path):
    """The tool's fixture (n images of one scene) against the JAX generator
    run with gen_synth_scale.py's arguments (two scenes, train_real then
    test), at small counts: the generator draws in loop order, so the first
    n samples hold the same poses and cameras and boxes within 1 px (the
    port's generator draws the hull and discs without OpenCV)."""
    n = 3
    proot = diag_overfit.make_fixture(str(tmp_path / "port"), n)
    jroot = str(tmp_path / "jax")
    jax_make_synthetic_bop(jroot, dataset="synth", n_objects=1, n_scenes=2,
                           folders={"train_real": 2 * n, "test": 2}, n_vertices=1024, seed=7,
                           raw_cache=False, write_png=False)
    got = scan_bop_object(proot, "synth", "train_real", 1, diag_overfit.VISIB_THRESHOLD)
    want = scan_bop_object(jroot, "synth", "train_real", 1, diag_overfit.VISIB_THRESHOLD)[:n]
    assert len(got) == n and [s.im_id for s in got] == [s.im_id for s in want] == [0, 1, 2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)
        np.testing.assert_array_equal(a.cam_K, b.cam_K)
        assert np.abs(a.bbox_visib - b.bbox_visib).max() <= 1
    # a second call finds the fixture and writes nothing
    stamp = os.path.getmtime(os.path.join(proot, "synth", "frame_cache", "index.json"))
    diag_overfit.make_fixture(proot, n)
    assert os.path.getmtime(os.path.join(proot, "synth", "frame_cache", "index.json")) == stamp


def test_diag_overfit_command_line_on_the_cpu(tmp_path, capsys):
    """`python -m checkerpose_tpu_torch.tools.diag_overfit --device cpu ...`
    at a tiny size: the JAX tool's log line at step 1, every --log_every
    steps and the last; `run` returns the curve, the state and the batch;
    without --device the card is asked for and its absence raises."""
    root = diag_overfit.make_fixture(str(tmp_path), 2)

    def argv(steps):
        return ["--device", "cpu", "--backbone", "hrnet_w18_small", "--n", "2", "--steps",
                str(steps), "--log_every", "2", "--aux", "1.0", "--root", root]

    assert diag_overfit.main(argv(3)) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 2", "step 3"]
    assert "| bit_err roi=" in lines[0] and "x=[" in lines[0] and "s/step)" in lines[0]
    out = diag_overfit.run(diag_overfit.parse_args(argv(1)))
    assert [c["step"] for c in out["curve"]] == [1]
    assert out["curve"][0]["bit_err"].shape == (7,) and np.isfinite(out["curve"][0]["loss"])
    assert out["state"].step == 1 and out["state"].module.training
    assert out["batch"]["image"].shape == (2, 256, 256, 3) and out["knn"].shape == (512, 20)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diag_overfit.run(diag_overfit.parse_args(["--root", root]))


def test_chip_smoke_trained_phase_rehearsed_on_cpu(tmp_path):
    """phase_trained at tiny size on the CPU (hrnet_w18_small, 4 crops, 2
    recipe steps, 1 PoseNet step): every part runs, the f32 copy and the
    plain EdgeConv agree bit for bit, the launch gate holds (nothing
    launches off the card), no device number is made up, and the result
    serialises. The learning gate (a) needs the card's hundreds of steps."""
    root = diag_overfit.make_fixture(str(tmp_path), 4)
    res = chip_smoke.phase_trained(torch.device("cpu"), backbone="hrnet_w18_small", n=4,
                                   steps_n=2, log_every=1, pose_steps=1, train_batch=2,
                                   data_root=root, trained_gates=False)
    recipe = res["recipe"]
    assert [c["step"] for c in recipe["curve"]] == [1, 2] and recipe["gate"]["gate_step"] == 2
    assert recipe["s"] is None and recipe["s_per_step"] is None
    init = res["init_kernels"]
    assert init["fma_vs_plain"]["differ"] == 0 and init["tc_vs_fma"]["bits"] == 4 * 512 * 7
    pose = res["pose"]
    assert pose["train_steps"] == 1 and pose["train_s"] is None
    heads = ["roi", "seg", "x_init", "x_refine", "y_init", "y_refine"]
    assert sorted(pose["kernel_bits"]) == sorted(pose["precision_bits"]) == heads
    # off the card the plain version is the CPU path itself: bf16 against it is exact
    assert all(a["differ"] == 0 for a in pose["kernel_bits"].values())
    assert init["tc_vs_plain_bf16"]["differ"] == 0
    evals = pose["evaluate_pipeline"]
    assert len(evals["f32"]) == len(evals["bf16"]) == len(evals["bf16_plain"]) == 3
    # off the card "tc" is the plain version, so the two bf16 paths report alike
    assert json.dumps(evals["bf16_plain"]) == json.dumps(evals["bf16"])  # NaN AUC alike
    assert all(v == {"tc": 0, "fma": 0} for v in res["launches_by_path"].values())
    json.dumps(res)


def _crops(*counts):
    return [c / 64 for c in counts]


@pytest.mark.parametrize("tc, plain, f32, held", [
    # the three paths alike
    (_crops(63, 64, 63), _crops(63, 63, 64), _crops(64, 63, 63), True),
    # "tc" one crop under the plain bf16 path's range: the seeds' own spread
    (_crops(60, 61, 60), _crops(62, 63, 62), _crops(62, 63, 63), True),
    # "tc" two crops under it on every seed: the kernel costs accuracy
    (_crops(59, 60, 59), _crops(62, 63, 62), _crops(62, 63, 63), False),
    # ... and two over it: the kernel is held both ways
    (_crops(64, 64, 64), _crops(60, 61, 61), _crops(61, 62, 62), False),
    # both bf16 paths three crops under f32 (bf16's own shortfall)
    (_crops(60, 61, 59), _crops(60, 60, 61), _crops(63, 63, 63), True),
    # "tc" as far under f32 as the plain bf16 path, less its spread
    (_crops(59, 59, 59), _crops(58, 61, 61), _crops(64, 64, 64), False),
    # bf16 over f32 as far as the plain bf16 path is
    (_crops(64, 64, 63), _crops(64, 63, 64), _crops(60, 61, 60), True),
    # the absolute bars: both bf16 paths 6 crops under f32 (the bar) ...
    (_crops(58, 58, 58), _crops(58, 57, 58), _crops(64, 64, 64), True),
    # ... and 7 under it, "tc" within the relative bars all the same
    (_crops(57, 57, 57), _crops(57, 56, 57), _crops(64, 64, 64), False),
    # both bf16 paths 3 crops over f32 (the bar is 2)
    (_crops(64, 64, 64), _crops(64, 64, 64), _crops(61, 60, 61), False),
])
def test_adx10_gate_of_the_trained_phase(tc, plain, f32, held):
    """Gate (c)'s adx10 check on crop counts of 64: "tc" within one crop of
    the plain bf16 path's range over the solver seeds, and within one crop of
    the f32 path's range beyond the plain bf16 path's own distance from it;
    that distance at most 6 crops below the f32 path's range and 2 above
    (the absolute bars)."""
    why = chip_smoke._adx10_gate(tc, plain, f32, 64)
    assert (why is None) == held, why


@pytest.mark.parametrize("share, held", [(0.05, True), (0.07, True), (0.09, False)])
def test_precision_gate_bars_bf16_itself_on_the_refine_bits(share, held):
    """Gate (c)'s bits check: where the plain bf16 forward leaves f32 in more
    than PLAIN_REFINE_SHARE_MAX of a refine head's bits, the head fails the
    absolute bar even though "tc" flips no more than the plain forward does
    (the relative bar)."""
    g = torch.Generator().manual_seed(0)
    B, N, S = 4, 50, 3                                # 600 bits a refine head
    f32 = {"roi_logit": torch.randn(B, N, 1, generator=g),
           "seg_logits": torch.randn(B, 8, 8, 2, generator=g),
           "x_logits": torch.randn(B, N, 3 + S, generator=g) + 3.0,
           "y_logits": torch.randn(B, N, 3 + S, generator=g) + 3.0}
    plain = {k: v.clone() for k, v in f32.items()}
    flips = round(share * B * N * S)
    for a in "xy":
        refine = plain[f"{a}_logits"][..., 3:].reshape(-1)
        refine[:flips] = -refine[:flips]
        plain[f"{a}_logits"][..., 3:] = refine.view(B, N, S)
    res = chip_smoke._precision_gate(plain, plain, f32)
    assert res["x_refine"]["plain_share"] == pytest.approx(flips / (B * N * S))
    assert res["roi"]["plain_share_bar"] is None and res["roi"]["plain_ok"] is None
    assert all(r["ok"] for r in res.values())           # "tc" flips what plain flips
    assert [res[f"{a}_refine"]["plain_ok"] for a in "xy"] == [held] * 2
