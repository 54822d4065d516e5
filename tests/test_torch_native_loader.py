"""The port's binding of the native decode + crop core
(`checkerpose_tpu_torch/data/native_loader.py`) and `CropDataset`'s native
paths, against the JAX package's binding (bit for bit), against cv2 and
against the port's python path: the cases of tests/test_native_loader.py,
and the build's place (`build/`, nothing written into `native/`)."""
import os
from pathlib import Path

import numpy as np
import pytest

from checkerpose_tpu.data import native_loader as jnl
from checkerpose_tpu.data.bop_io import scan_bop_object as jscan
from checkerpose_tpu.data.dataset import CropDataset as JCropDataset
from checkerpose_tpu.data.fps import load_keypoints_normed as jkeypoints
from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu_torch.data import native_loader as nl
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, Loader
from checkerpose_tpu_torch.data.fps import load_keypoints_normed
from checkerpose_tpu_torch.ops.crop import get_roi_np

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def core():
    assert nl.available(), nl.build_error()
    return nl


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bop"))
    jax_make_synthetic_bop(root, n_objects=1, n_scenes=1, n_images=4,
                           folders=("test", "train_real"))
    return root


def _paths(root):
    return (f"{root}/synth/test/000000/rgb/000000.png",
            f"{root}/synth/test/000000/mask/000000_000000.png")


@pytest.mark.parametrize("bbox", [
    [250., 150., 180., 140.],
    [-40., -30., 200., 260.],    # off top-left
    [500., 380., 220., 160.],    # off bottom-right
    [0., 10., 100., 31.],        # squaring puts the corner at -24.5 (truncation toward 0)
    [3., -9., 121., 60.],        # the same with an odd long side
])
def test_native_matches_jax_binding_and_cv2(core, synth, bbox):
    cv2 = pytest.importorskip("cv2")
    rgb, mask = _paths(synth)
    bbox = np.array(bbox)
    got = core.load_sample(rgb, mask, mask, bbox, 256, 64)
    want = jnl.load_sample(rgb, mask, mask, bbox, 256, 64)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3] == (640, 480)
    img = cv2.imread(rgb)[:, :, ::-1]
    msk = cv2.imread(mask, 0)
    img_c = get_roi_np(img, bbox, 256, "linear", "crop_square_resize")
    mf_c = get_roi_np(msk, bbox, 64, "nearest", "crop_square_resize").astype(np.float32) / 255.0
    assert np.abs(got[0].astype(int) - img_c.astype(int)).max() <= 1      # rounding
    np.testing.assert_array_equal(got[1], mf_c)


def test_native_batch_failures_zero_filled(core, synth):
    rgb, mask = _paths(synth)
    bboxes = np.tile(np.array([250., 150., 180., 140.]), (3, 1))
    args = ([rgb, "/nonexistent.png", rgb], [mask] * 3, [mask] * 3, bboxes, 128, 32)
    core.reset_counts()
    imgs, mf, mv, fails = core.load_batch(*args)
    assert fails == 1 and imgs.shape == (3, 128, 128, 3)
    assert imgs[1].sum() == 0 and mf[1].sum() == 0 and mv[1].sum() == 0
    assert imgs[0].sum() > 0 and np.array_equal(imgs[0], imgs[2])
    for a, b in zip((imgs, mf, mv, fails), jnl.load_batch(*args)):
        assert np.array_equal(a, b)
    assert core.counts == {"items": 3, "batches": 1}
    with pytest.raises(OSError, match="rc=1"):
        core.load_sample("/nonexistent.png", mask, mask, bboxes[0], 128, 32)
    with pytest.raises(ValueError, match="bboxes"):
        core.load_batch([rgb], [mask], [mask], bboxes, 128, 32)


def test_cropdataset_native_matches_python(core, synth):
    samples = scan_bop_object(synth, "synth", "test", 1)
    xyz, _ = load_keypoints_normed(synth, "synth", 1, 64)
    ds_py = CropDataset(samples, xyz, is_train=False, use_native=False)
    ds_na = CropDataset(samples, xyz, is_train=False)               # the default
    assert ds_na.use_native and not ds_py.use_native
    core.reset_counts()
    a, b = ds_py[0], ds_na[0]
    assert core.counts["items"] == 1
    assert np.abs(a["image"].astype(int) - b["image"].astype(int)).max() <= 1
    for k in a:
        if k != "image":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cropdataset_native_matches_jax(core, synth):
    """Item by item, in train mode too (the bbox jitter's draws), and batch
    by batch through the batch API: the port's native items equal JAX's."""
    xyz = jkeypoints(synth, "synth", 1, 64)[0]
    for folder, is_train in (("test", False), ("train_real", True)):
        kw = dict(is_train=is_train, seed=3)
        ds = CropDataset(scan_bop_object(synth, "synth", folder, 1), xyz, **kw)
        jds = JCropDataset(jscan(synth, "synth", folder, 1), xyz, use_native=True, **kw)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} of {i}")
        got, want = ds.get_batch(np.arange(len(ds))), jds.get_batch(np.arange(len(jds)))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_loader_uses_native_batch_api(core, synth):
    """Loader assembles whole batches through one threaded call when the
    dataset supports it; they equal the python item path's (eval bboxes)."""
    samples = scan_bop_object(synth, "synth", "train_real", 1)
    xyz, _ = load_keypoints_normed(synth, "synth", 1, 64)
    ds_n = CropDataset(samples, xyz, is_train=False)
    ds_p = CropDataset(samples, xyz, is_train=False, use_native=False)
    assert ds_n.supports_batch() and not ds_p.supports_batch()
    core.reset_counts()
    bn = next(iter(Loader(ds_n, 4, shuffle=False, infinite=False)))
    bp = next(iter(Loader(ds_p, 4, shuffle=False, infinite=False)))
    assert core.counts == {"items": 4, "batches": 1}
    np.testing.assert_allclose(bn["image"], bp["image"], atol=1.0)
    for k in ("mask_visib", "mask_full", "valid"):
        np.testing.assert_allclose(bn[k], bp[k], atol=1.0 / 255.0)
    for k in ("bbox", "proj_xy"):
        np.testing.assert_allclose(bn[k], bp[k], atol=1e-4)
    assert bn["valid"].sum() == 4.0 and bn["n_real"] == 4


def test_native_batch_warp_affine_method(core, synth):
    """crop_resize_by_warp_affine takes the batch API too (the same square
    mapping); crop_resize does not, and get_batch refuses it (the batch call
    reports no image size, which its final bbox needs)."""
    samples = scan_bop_object(synth, "synth", "train_real", 1)
    xyz, _ = load_keypoints_normed(synth, "synth", 1, 64)
    kw = dict(is_train=False, resize_method="crop_resize_by_warp_affine")
    ds_n = CropDataset(samples, xyz, **kw)
    ds_p = CropDataset(samples, xyz, use_native=False, **kw)
    assert ds_n.supports_batch()
    bn = next(iter(Loader(ds_n, 2, shuffle=False, infinite=False)))
    bp = next(iter(Loader(ds_p, 2, shuffle=False, infinite=False)))
    np.testing.assert_allclose(bn["image"], bp["image"], atol=1.0)
    np.testing.assert_allclose(bn["bbox"], bp["bbox"], atol=1e-4)
    assert bn["valid"].sum() == 2.0
    plain = CropDataset(samples, xyz, is_train=False, resize_method="crop_resize")
    assert plain.use_native and not plain.supports_batch()
    with pytest.raises(ValueError, match="square resize method"):
        plain.get_batch([0, 1])


def _listing(d: Path):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.iterdir()}


def test_build_lands_in_build_and_leaves_native_alone(core, tmp_path, monkeypatch):
    """The library the port loads sits under build/ at the repo root, and a
    fresh build (into another directory here) writes nothing into native/."""
    assert nl.library_path().parent == ROOT / "build" and nl.library_path().is_file()
    before = _listing(ROOT / "native")
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path)
    lib = nl.build()
    assert lib.parent == tmp_path and lib.is_file() and os.listdir(tmp_path) == [lib.name]
    assert _listing(ROOT / "native") == before


def test_unavailable_core_keeps_the_python_path(synth, monkeypatch):
    """Where the core does not build, CropDataset takes the python path
    (and says why through build_error)."""
    monkeypatch.setattr(nl, "_state", {"lib": None, "error": "g++: png.h: no such file"})
    assert not nl.available() and "png.h" in nl.build_error()
    ds = CropDataset(scan_bop_object(synth, "synth", "test", 1),
                     load_keypoints_normed(synth, "synth", 1, 64)[0], is_train=False)
    assert not ds.use_native and not ds.supports_batch()
    assert ds[0]["valid"] == 1.0
