"""The port's BOP scoring entry point (`checkerpose_tpu_torch/cli/eval_bop.py`),
its depth PNG codec (`data/imageio.py`), the fixture's depth maps and the
workflow's host tools (`cli/merge_csv.py`, `cli/get_fps_points.py`,
`cli/convert_cfg_lmo_to_ycbv.py`, `data/visibility.py`) against the JAX
package's, small fixtures on the CPU.

eval_bop's MSSD and MSPD are f32 on both sides with the products in another
order (1e-5 relative, tests/test_torch_bop_scores.py); the recall compares
each error with a threshold, so the test first checks that no error lies
within 1e-5 relative of one, and then the reports agree to 1e-9."""
import os
import pickle
import struct
import sys
import zlib
from collections import defaultdict
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from checkerpose_tpu.cli import convert_cfg_lmo_to_ycbv as jconvert
from checkerpose_tpu.cli import eval_bop as jeval_bop, get_fps_points as jfps_cli
from checkerpose_tpu.cli import merge_csv as jmerge
from checkerpose_tpu.data import visibility as jvis
from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu_torch.cli import convert_cfg_lmo_to_ycbv as pconvert
from checkerpose_tpu_torch.cli import eval_bop as peval_bop, get_fps_points as pfps_cli
from checkerpose_tpu_torch.cli import merge_csv as pmerge
from checkerpose_tpu_torch.data import imageio, visibility as pvis
from checkerpose_tpu_torch.data.bop_io import load_models_info, model_ply_path, scan_bop_object
from checkerpose_tpu_torch.data.ply import load_ply_vertices
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.eval import bop_scores as B

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = dict(n_objects=1, n_scenes=2, n_images=3, n_vertices=100, folders=("test",))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The same fixture (seed 0) written by each package's generator: the
    JAX one with its PNGs, the port's as a frame cache only (no rgb files,
    depth PNGs all the same)."""
    jroot = str(tmp_path_factory.mktemp("jax_fixture"))
    jax_make_synthetic_bop(jroot, **FIXTURE)
    proot = str(tmp_path_factory.mktemp("port_fixture"))
    make_synthetic_bop(proot, **FIXTURE, raw_cache=True, write_png=False)
    return {"jax": jroot, "port": proot}


def _depth_paths(root):
    return sorted(Path(root, "synth", "test").glob("*/depth/*.png"))


def test_fixture_depth_pngs_match_jax(fixtures):
    """Same seed: the port's depth PNGs against the JAX fixture's, >= 99.9%
    of pixels equal and none off by more than 1 mm."""
    jpaths, ppaths = _depth_paths(fixtures["jax"]), _depth_paths(fixtures["port"])
    assert len(jpaths) == len(ppaths) == FIXTURE["n_scenes"] * FIXTURE["n_images"]
    for jp, pp in zip(jpaths, ppaths):
        assert jp.relative_to(fixtures["jax"]) == pp.relative_to(fixtures["port"])
        dj = cv2.imread(str(jp), cv2.IMREAD_UNCHANGED)
        dp = cv2.imread(str(pp), cv2.IMREAD_UNCHANGED)
        assert dp.dtype == dj.dtype == np.uint16 and dp.shape == dj.shape == (480, 640)
        assert (dj > 0).any()
        d = np.abs(dj.astype(np.int64) - dp.astype(np.int64))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (jp, d.max(), (d == 0).mean())


def test_fixture_writes_depth_without_a_codec(fixtures, monkeypatch, tmp_path):
    """cv2 and PIL unimportable: the depth PNGs are still written (by the
    port's own encoder) and hold the values the codec-written ones hold."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    make_synthetic_bop(str(tmp_path), **FIXTURE)
    monkeypatch.undo()
    for a, b in zip(_depth_paths(fixtures["port"]), _depth_paths(tmp_path), strict=True):
        np.testing.assert_array_equal(cv2.imread(str(b), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(str(a), cv2.IMREAD_UNCHANGED))


# --- the PNG codec -----------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img, ftypes):
    """PNG bytes of a grayscale uint8 or uint16 image whose row y carries
    filter ftypes[y % len(ftypes)] (0 none, 1 sub, 2 up, 3 average, 4 Paeth),
    written here from the PNG specification."""
    h, w = img.shape
    bpp = img.dtype.itemsize
    raw = img.astype(">u2" if bpp == 2 else np.uint8).view(np.uint8).reshape(h, w * bpp)
    out, prior = [], [0] * (w * bpp)
    for y in range(h):
        ft, row = ftypes[y % len(ftypes)], [int(v) for v in raw[y]]
        enc = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][ft]
            enc.append((x - pred) & 0xFF)
        out.append(bytes([ft] + enc))
        prior = row
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * bpp, 0, 0, 0, 0)
    return (imageio._PNG_SIG + imageio._chunk(b"IHDR", ihdr)
            + imageio._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + imageio._chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("ftypes", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_decoder_undoes_every_row_filter(dtype, ftypes, tmp_path):
    """Each of the five row filters, checked against cv2's reading of the
    same bytes; the port's decoder returns the values unchanged."""
    rng = np.random.default_rng(len(ftypes) * 10 + ftypes[0])
    img = rng.integers(0, np.iinfo(dtype).max + 1, (7, 13)).astype(dtype)
    img[0, 0], img[-1, -1] = 0, np.iinfo(dtype).max
    data = _filtered_png(img, ftypes)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
    got = imageio.decode_gray_png(data)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("shape", [(1, 1), (5, 17), (480, 640)])
def test_encoder_round_trips_and_cv2_reads_it(shape, tmp_path):
    rng = np.random.default_rng(shape[1])
    depth = rng.integers(0, 65536, shape).astype(np.uint16)
    depth.flat[0] = 65535
    data = imageio.encode_gray16_png(depth)
    np.testing.assert_array_equal(imageio.decode_gray_png(data), depth)
    path = tmp_path / "d.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), depth)
    assert imageio.png_size(str(path)) == (shape[1], shape[0])


@pytest.mark.parametrize("codec", ["cv2", "pil", "own"])
def test_depth_png_io_through_each_codec(codec, monkeypatch, tmp_path):
    """read_depth_png / write_depth_png go through the package's own codec
    whether cv2, Pillow alone or neither imports: files written by cv2 and
    by Pillow read back unchanged, what the helper writes cv2 reads
    unchanged; a missing file or a colour PNG is None."""
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 65536, (48, 64)).astype(np.uint16)
    gray8 = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "cv2.png"), depth)
    cv2.imwrite(str(tmp_path / "cv2_8.png"), gray8)
    Image.fromarray(depth).save(tmp_path / "pil.png")
    cv2.imwrite(str(tmp_path / "rgb.png"), np.dstack([gray8] * 3))
    if codec != "cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    if codec == "own":
        monkeypatch.setitem(sys.modules, "PIL", None)
    assert imageio.have_codec() == (codec != "own")
    for name in ("cv2.png", "pil.png"):
        got = imageio.read_depth_png(str(tmp_path / name))
        assert got.dtype == np.uint16, name
        np.testing.assert_array_equal(got, depth)
    np.testing.assert_array_equal(imageio.read_depth_png(str(tmp_path / "cv2_8.png")), gray8)
    imageio.write_depth_png(str(tmp_path / "out.png"), depth)
    assert imageio.read_depth_png(str(tmp_path / "missing.png")) is None
    assert imageio.read_depth_png(str(tmp_path / "rgb.png")) is None
    assert imageio.png_size(str(tmp_path / "rgb.png")) == (64, 48)
    monkeypatch.undo()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "out.png"), cv2.IMREAD_UNCHANGED),
                                  depth)
    (tmp_path / "not_png.png").write_bytes(b"GIF89a" + bytes(40))
    assert imageio.png_size(str(tmp_path / "not_png.png")) is None
    assert imageio.png_size(str(tmp_path / "missing.png")) is None


# --- eval_bop ----------------------------------------------------------------------------


def _rot(axis, deg):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.deg2rad(deg)
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def _write_csv(root, path, kind):
    """A CSV of the fixture's GT poses, or of poses perturbed by a seeded
    rotation (0-20 deg) and translation (sd 8 mm) plus a lower-scored second
    estimate on every other image."""
    rng = np.random.default_rng(7)
    rows = []
    for s in scan_bop_object(root, "synth", "test", 1, -1.0):
        R, t = s.R, s.t
        if kind == "perturbed":
            R = _rot(rng.normal(size=3), rng.uniform(0, 20)) @ R
            t = t + rng.normal(0, 8.0, 3)
        rows.append((s.scene_id, s.im_id, 0.9, R, t))
        if kind == "perturbed" and s.im_id % 2 == 0:
            rows.append((s.scene_id, s.im_id, 0.4, _rot([0, 1, 0], 40) @ s.R, s.t + [0, 0, 30]))
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for sc, im, score, R, t in rows:
            f.write(f"{sc},{im},1,{score},{' '.join(repr(float(x)) for x in R.ravel())},"
                    f"{' '.join(repr(float(x)) for x in t)},-1\n")
    return rows


def _assert_margins(root, csv_path):
    """No MSSD or MSPD error of the CSV's pairs lies within 1e-5 relative of
    a recall threshold, so f32 rounding cannot move a recall."""
    gts = defaultdict(list)
    for s in scan_bop_object(root, "synth", "test", 1, -1.0):
        gts[(s.scene_id, s.im_id)].append(s)
    pairs = [(r, g) for r in B.load_bop_results_csv(csv_path) for g in gts[(r["scene_id"],
                                                                           r["im_id"])]]
    verts = load_ply_vertices(model_ply_path(root, "synth", 1, eval_models=True))
    info = load_models_info(root, "synth", eval_models=True)[1]
    errs = B.batched_bop_errors(*(np.stack(a) for a in (
        [r["R"] for r, _ in pairs], [r["t"] for r, _ in pairs], [g.R for _, g in pairs],
        [g.t for _, g in pairs], [g.cam_K for _, g in pairs])), verts, *B.sym_arrays(info),
        device="cpu")
    for e, th in ((errs["mssd"].double().numpy(), B.MSSD_THRESHOLDS * info["diameter"]),
                  (errs["mspd"].double().numpy(), B.MSPD_THRESHOLDS)):
        margin = np.abs(e[:, None] / th[None] - 1.0).min()
        assert margin > 1e-5, margin


def _assert_reports_close(got, want, path="report"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_reports_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert abs(got - want) <= 1e-9, (path, got, want)


@pytest.mark.parametrize("which", ["jax", "port"])
@pytest.mark.parametrize("kind", ["gt", "perturbed"])
def test_eval_bop_matches_jax(fixtures, which, kind, tmp_path, monkeypatch):
    """The port's eval_bop.main on the CPU against JAX's main on the same
    fixture and CSV (the JAX fixture has rgb PNGs for the width probe, the
    port's has none): the reports agree to 1e-9, VSD included; MSSD and MSPD
    take every pair in one call and VSD renders depth."""
    root = fixtures[which]
    csv_path = str(tmp_path / f"{kind}.csv")
    rows = _write_csv(root, csv_path, kind)
    _assert_margins(root, csv_path)
    want = jeval_bop.main(csv_path, root, "synth")
    calls, renders = [], []
    errors, render = B.batched_bop_errors, B.render_depth
    monkeypatch.setattr(B, "batched_bop_errors",
                        lambda *a, **k: calls.append((len(a[0]), len(a[6]))) or errors(*a, **k))
    monkeypatch.setattr(B, "render_depth", lambda *a: renders.append(1) or render(*a))
    got = peval_bop.main(csv_path, root, "synth", device="cpu")
    _assert_reports_close(got, want)
    assert "ar_vsd" in got["per_object"][1] and got["per_object"][1]["n_estimates"] == len(rows)
    if kind == "gt":
        assert got["overall"]["ar_mssd"] == got["overall"]["ar_mspd"] == 1.0
        assert got["overall"]["ar_vsd"] > 0.95
    else:
        assert 0.0 < got["overall"]["ar"] < 1.0
    assert calls == [(len(rows), 1)] and renders


def test_eval_bop_refuses_a_malformed_csv(fixtures, tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("scene_id,im_id,obj_id,score,R,t,time\n0,0,1,0.5,1 0 0,1 2 3,-1\n")
    assert peval_bop.main(str(path), fixtures["port"], "synth", device="cpu") is None
    assert jeval_bop.main(str(path), fixtures["port"], "synth") is None


def test_eval_bop_defaults_to_the_card(fixtures, tmp_path):
    """Without a card, main raises before it reads any file; --device
    defaults to cuda."""
    assert peval_bop.parse_args(["--csv", "x", "--bop_path", "y", "--dataset", "z"]).device \
        == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval_bop.main(str(tmp_path / "missing.csv"), fixtures["port"], "synth")


# --- host tools --------------------------------------------------------------------------


def test_merge_csv_byte_identical(tmp_path, monkeypatch, capsys):
    outs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        for i, obj in enumerate((3, 1, 2)):
            (d / f"cfg_obj{obj:02d}.csv").write_text(
                "scene_id,im_id,obj_id,score,R,t,time\n"
                f"{i},{obj},{obj},0.5,1 0 0 0 1 0 0 0 1,1 2 {300 + obj},-1\n"
                f"{i},{obj + 1},{obj},0.25,0 1 0 -1 0 0 0 0 1,4 5 6,0.125\n")
    monkeypatch.setattr(sys, "argv", ["merge_csv", "--input_dir", str(tmp_path / "jax"),
                                      "--output_fn", "all.csv"])
    jmerge.main()
    outs["jax"] = (tmp_path / "jax" / "all.csv").read_bytes()
    out = pmerge.main(["--input_dir", str(tmp_path / "port"), "--output_fn", "all.csv"])
    assert out == str(tmp_path / "port" / "all.csv")
    outs["port"] = Path(out).read_bytes()
    assert outs["port"] == outs["jax"] and outs["port"].count(b"\n") == 7
    # a second merge leaves the earlier output out of its inputs
    assert pmerge.main(["--input_dir", str(tmp_path / "port"), "--output_fn", "all.csv"])
    assert Path(out).read_bytes() == outs["jax"]


def test_get_fps_points_pickles_equal(fixtures):
    root = fixtures["port"]
    jfps_cli.main(root, "synth", npoint_log2=5, fps_version="fps_jax")
    pfps_cli.main(root, "synth", npoint_log2=5, fps_version="fps_port")
    assert pfps_cli.parse_args(["--bop_path", root, "--dataset", "synth"]).npoint_log2 == 12
    name = "obj_000001.pkl"
    with open(os.path.join(root, "synth", "fps_jax", name), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(root, "synth", "fps_port", name), "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) == ["id", "npoint", "xyz"]
    assert got["npoint"] == want["npoint"] == 32
    for k in ("id", "xyz"):
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("cfg", sorted(p.name for p in (ROOT / "config" / "lmo").glob("*.txt")))
def test_convert_cfg_lmo_to_ycbv_text_identical(cfg, tmp_path):
    src = str(ROOT / "config" / "lmo" / cfg)
    jconvert.convert(src, str(tmp_path / "j" / cfg))
    pconvert.convert(src, str(tmp_path / "p" / cfg), "dets/ycbv.json")
    jconvert.convert(src, str(tmp_path / "j2" / cfg), "dets/ycbv.json")
    pconvert.convert(src, str(tmp_path / "p_default" / cfg))
    assert (tmp_path / "p_default" / cfg).read_text() == (tmp_path / "j" / cfg).read_text()
    assert (tmp_path / "p" / cfg).read_text() == (tmp_path / "j2" / cfg).read_text()
    assert "dataset_name = ycbv\n" in (tmp_path / "p" / cfg).read_text()


def test_visibility_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 40.0, (80, 3))
    Rj, Rp = jvis.sample_view_rotations(24, seed=3), pvis.sample_view_rotations(24, seed=3)
    np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-12)
    cam = pts @ Rp[0].T + [0, 0, 400.0]
    np.testing.assert_array_equal(pvis.compute_vis_hpr(cam), jvis.compute_vis_hpr(cam))
    got = pvis.overall_visibility(pts, Rp, t_z=350.0, gamma_exp=1.5)
    want = jvis.overall_visibility(pts, Rj, t_z=350.0, gamma_exp=1.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert 0.0 < got.mean() < 1.0
