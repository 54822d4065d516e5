"""The port's multi-object data layer against the JAX package's (mirrors
tests/test_lm_imgn.py) on trees written with cv2, small, on the CPU:

  * `scan_lm_imgn`: the same manifest, field by field;
  * lm_imgn items take both masks from depth > 0;
  * `CropDataset` with a {obj_id: (N, 3)} table: obj_idx and proj_xy exact;
    with bg_paths and one seed the same draws (the generators' states equal
    after every item) and so the same backgrounds; images equal on >= 99.5%
    of values and within 2 grey levels where the numpy bilinear resize of
    the background and of the crop rounds differently from cv2.resize
    (measured: see `test_table_mode_and_background_swap_match_jax`);
  * `build_train_loaders_lm`, lm_imgn branch: the MixedLoader's batch
    structure and sizes;
  * the RGB PNG codec of data/imageio.py: round trip, cv2-written files read
    exactly, and the library-free read path.
"""
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from checkerpose_tpu.cli import common as jcommon  # noqa: E402
from checkerpose_tpu.data import dataset as jdataset  # noqa: E402
from checkerpose_tpu.data.bop_io import scan_bop_object as jscan_bop  # noqa: E402
from checkerpose_tpu.data.lm_imgn import scan_lm_imgn as jscan  # noqa: E402
from checkerpose_tpu.data.synthetic import (  # noqa: E402
    make_synthetic_bop as jax_make_synthetic_bop)
from checkerpose_tpu_torch.cli import common  # noqa: E402
from checkerpose_tpu_torch.data import dataset as pdataset, imageio  # noqa: E402
from checkerpose_tpu_torch.data.bop_io import scan_bop_object  # noqa: E402
from checkerpose_tpu_torch.data.lm_imgn import K_LM, scan_lm_imgn  # noqa: E402

NPT = 16
BG_COLOURS = ((200, 40, 40), (30, 180, 60), (20, 60, 210))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """An lm_imgn tree of two objects (7 and 5 renders; the second as the
    `benchviseblue` alias of `benchvise`), a BOP tree of two objects, and
    three solid-colour background PNGs, all written with cv2."""
    root = tmp_path_factory.mktemp("lm_data")
    rng = np.random.default_rng(0)
    for folder, n in (("ape", 7), ("benchviseblue", 5)):
        obj_dir = root / "lm_imgn" / "imgn" / folder
        obj_dir.mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
            depth = np.zeros((480, 640), np.uint16)
            x0, y0 = 200 + 10 * i, 150 + 5 * i
            depth[y0:y0 + 80, x0:x0 + 60] = 500 + i
            R, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            t_m = np.array([0.01 * i, -0.02, 0.45])
            with open(obj_dir / f"{i:06d}-pose.txt", "w") as f:
                f.write("rotation translation\n")
                np.savetxt(f, np.hstack([R, t_m[:, None]]))
            cv2.imwrite(str(obj_dir / f"{i:06d}-color.png"), img)
            cv2.imwrite(str(obj_dir / f"{i:06d}-depth.png"), depth)
    # an empty mask: filtered out by the area < 3 rule
    cv2.imwrite(str(root / "lm_imgn" / "imgn" / "ape" / "000099-color.png"),
                np.zeros((480, 640, 3), np.uint8))
    cv2.imwrite(str(root / "lm_imgn" / "imgn" / "ape" / "000099-depth.png"),
                np.zeros((480, 640), np.uint16))
    with open(root / "lm_imgn" / "imgn" / "ape" / "000099-pose.txt", "w") as f:
        f.write("pose\n")
        np.savetxt(f, np.hstack([np.eye(3), np.ones((3, 1))]))
    bg_dir = root / "bg"
    bg_dir.mkdir()
    for k, c in enumerate(BG_COLOURS):
        cv2.imwrite(str(bg_dir / f"bg{k}.png"), np.full((48, 64, 3), c[::-1], np.uint8))
    bop = str(root / "bop")
    jax_make_synthetic_bop(bop, n_objects=2, n_scenes=1, n_images=4, folders=("train_real",))
    rng = np.random.default_rng(1)
    table = {1: rng.uniform(-30, 30, (NPT, 3)), 2: rng.uniform(-30, 30, (NPT, 3))}
    return dict(imgn=str(root / "lm_imgn"), bg=str(bg_dir), bop=bop, table=table)


def _fields(s):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in vars(s).items()}


@pytest.mark.parametrize("name,n_per_obj", [("ape", 4), ("ape", 0), ("benchvise", 3),
                                            ("cat", 0)])
def test_scan_lm_imgn_matches_jax(trees, name, n_per_obj):
    got = scan_lm_imgn(trees["imgn"], name, 1, n_per_obj=n_per_obj)
    want = jscan(trees["imgn"], name, 1, n_per_obj=n_per_obj)
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    if name == "ape" and n_per_obj == 4:
        # linspace over 8 ids picks 0, 2, 4 and 7; the last, 000099, has an empty mask
        assert [s.im_id for s in got] == [0, 1, 2]
        assert [s.rgb_path[-16:-10] for s in got] == ["000000", "000002", "000004"]
        np.testing.assert_allclose(got[0].t, [0.0, -20.0, 450.0])
        assert got[0].bbox_visib.tolist() == [200, 150, 60, 80]
        np.testing.assert_array_equal(got[0].cam_K, K_LM)
        assert all(s.depth_path and s.img_type == "syn" for s in got)
    if name == "cat":
        assert got == []


def test_imgn_item_masks_from_depth(trees):
    samples = scan_lm_imgn(trees["imgn"], "ape", 1, n_per_obj=0)
    ds = pdataset.CropDataset(samples, trees["table"], is_train=False)
    item = ds[0]
    assert item["valid"] == 1.0 and item["obj_idx"] == 0
    assert item["mask_visib"].max() == 1.0
    np.testing.assert_array_equal(item["mask_visib"], item["mask_full"])
    ref = jdataset.CropDataset(jscan(trees["imgn"], "ape", 1, n_per_obj=0), trees["table"],
                               is_train=False, use_native=False)[0]
    for k in ("mask_visib", "mask_full", "proj_xy", "bbox", "obj_idx"):
        np.testing.assert_array_equal(item[k], ref[k], err_msg=k)


def test_table_mode_and_background_swap_match_jax(trees):
    """Train items of both objects' real images and of lm_imgn renders with
    three backgrounds, change_bg_prob 0.5, one seed: every item's obj_idx,
    proj_xy, bbox and masks equal JAX's, the two generators stay in the same
    state item after item, and the images agree on >= 99.5% of values
    (measured 99.986%), within 2 grey levels elsewhere (measured 1)."""
    real = [s for o in (1, 2) for s in scan_bop_object(trees["bop"], "synth", "train_real", o)]
    jreal = [s for o in (1, 2) for s in jscan_bop(trees["bop"], "synth", "train_real", o)]
    syn = scan_lm_imgn(trees["imgn"], "benchvise", 2, n_per_obj=0)
    jsyn = jscan(trees["imgn"], "benchvise", 2, n_per_obj=0)
    bg = [f"{trees['bg']}/bg{k}.png" for k in range(len(BG_COLOURS))]
    kw = dict(is_train=True, seed=3, bg_paths=bg, change_bg_prob=0.5)
    ds = pdataset.CropDataset(real + syn, trees["table"], **kw)
    jds = jdataset.CropDataset(jreal + jsyn, trees["table"], use_native=False, **kw)
    equal = worst = n = 0
    seen_objects = set()
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert ds.rng.bit_generator.state == jds.rng.bit_generator.state, i
        for k in ("obj_idx", "obj_id", "proj_xy", "bbox", "mask_visib", "mask_full", "valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} of item {i}")
        d = np.abs(got["image"].astype(int) - want["image"].astype(int))
        equal += int((d == 0).sum())
        n += d.size
        worst = max(worst, int(d.max()))
        seen_objects.add(int(got["obj_idx"]))
    assert seen_objects == {0, 1}
    assert equal / n >= 0.995 and worst <= 2, (equal / n, worst)
    # an lm_imgn render's corner is background: one of the solid colours
    corner = ds[len(real)]["image"][:3, :3].reshape(-1, 3).astype(int)
    assert min(np.abs(corner - np.array(c)).max() for c in BG_COLOURS) <= 2


@pytest.mark.parametrize("method", ["crop_square_resize", "crop_resize"])
def test_windowed_background_swap_equals_the_whole_frame_swap(trees, method, tmp_path):
    """The swap resizes and replaces only the window the crop reads: its crop
    equals, value for value, the crop of the whole frame swapped, for boxes
    inside, across the edge of and outside the frame."""
    from checkerpose_tpu_torch.ops.crop import get_roi_np, resize_linear_u8
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    mask = np.zeros((480, 640), np.uint8)
    mask[100:300, 200:420] = 255
    bg_path = str(tmp_path / "bg_noise.png")
    cv2.imwrite(bg_path, rng.integers(0, 256, (120, 170, 3)).astype(np.uint8))
    ds = pdataset.CropDataset([], trees["table"], is_train=True, resize_method=method)
    whole = img.copy()
    bg = resize_linear_u8(cv2.imread(bg_path)[:, :, ::-1], 480, 640)
    whole[mask <= 127] = bg[mask <= 127]
    boxes = [[150.3, 90.8, 300.2, 230.5], [-40.0, 400.0, 180.0, 150.0],
             [600.0, -30.0, 90.0, 120.0]]
    if method == "crop_square_resize":          # a crop_resize box must meet the frame
        boxes.append([700.0, 500.0, 20.0, 20.0])
    for bbox in boxes:
        got = get_roi_np(ds._replace_bg(img, mask, bg_path, np.array(bbox)), bbox, 256,
                         "linear", method)
        np.testing.assert_array_equal(got, get_roi_np(whole, bbox, 256, "linear", method))


def test_build_train_loaders_lm_imgn_branch(trees):
    """cfg `training_data_folder_2 = lm_imgn`: a MixedLoader of real images
    and renders at second_dataset_ratio whose batches hold JAX's keys,
    shapes, dtypes and objects; `background_root` turns the swap on."""
    cfg = {"bop_path": trees["bop"], "dataset_name": "synth",
           "training_data_folder": "train_real", "training_data_folder_2": "lm_imgn",
           "lm_imgn_root": trees["imgn"], "imgn_n_per_obj": 0, "second_dataset_ratio": 0.5,
           "batch_size": 4, "obj_ids": [1, 2], "obj_names": ["ape", "benchvise"],
           "train_obj_visible_theshold": 0.1, "val_folder": "train_real",
           "background_root": trees["bg"],
           "change_bg_prob": 0.5}
    train, val = common.build_train_loaders_lm(cfg, trees["table"])
    jtrain, jval = jcommon.build_train_loaders_lm(cfg, trees["table"])
    assert isinstance(train, pdataset.MixedLoader) and isinstance(jtrain, jdataset.MixedLoader)
    assert train.loader1.batch_size == jtrain.loader1.batch_size == 2
    assert len(train.loader2.ds) == len(jtrain.loader2.ds) == 12
    assert train.loader1.ds.bg_paths == jtrain.loader1.ds.bg_paths and len(
        train.loader1.ds.bg_paths) == 3
    b, jb = next(iter(train)), next(iter(jtrain))
    assert sorted(b) == sorted(jb)
    for k in jb:
        assert np.shape(b[k]) == np.shape(jb[k]) and np.asarray(b[k]).dtype == np.asarray(
            jb[k]).dtype, k
    np.testing.assert_array_equal(b["obj_idx"], jb["obj_idx"])
    assert b["image"].shape == (4, 256, 256, 3) and b["valid"].sum() == 4.0
    vb, jvb = next(iter(val(2))), next(iter(jval(2)))
    assert sorted(vb) == sorted(jvb) and (vb["obj_idx"] == 1).all()
    np.testing.assert_array_equal(vb["proj_xy"], jvb["proj_xy"])


def test_rgb_png_codec(tmp_path, monkeypatch):
    """write_rgb_png round-trips and cv2 reads it; cv2-written RGB PNGs (its
    filters chosen per row) decode exactly; with neither cv2 nor Pillow,
    read_image decodes RGB and gray PNGs by the codec (gray read as colour
    repeats the channel) and refuses a JPEG, an RGB file read as gray and a
    missing file with an error that names the frame cache."""
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    smooth = (np.add.outer(np.arange(40), np.arange(50))[..., None]
              * np.array([1, 2, 3])).astype(np.uint8)
    gray = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    for name, img in (("noise", noise), ("smooth", smooth)):
        ours = tmp_path / f"{name}_own.png"
        imageio.write_rgb_png(str(ours), img)
        np.testing.assert_array_equal(imageio.decode_png(ours.read_bytes()), img)
        np.testing.assert_array_equal(cv2.imread(str(ours))[:, :, ::-1], img)
        theirs = tmp_path / f"{name}_cv2.png"
        cv2.imwrite(str(theirs), img[:, :, ::-1])
        np.testing.assert_array_equal(imageio.decode_png(theirs.read_bytes()), img)
        assert imageio.decode_gray_png(theirs.read_bytes()) is None
    cv2.imwrite(str(tmp_path / "gray.png"), gray)
    cv2.imwrite(str(tmp_path / "img.jpg"), noise)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert not imageio.have_codec()
    np.testing.assert_array_equal(imageio.read_image(str(tmp_path / "noise_cv2.png")), noise)
    np.testing.assert_array_equal(imageio.read_image(str(tmp_path / "gray.png"), gray=True),
                                  gray)
    np.testing.assert_array_equal(imageio.read_image(str(tmp_path / "gray.png")),
                                  np.repeat(gray[:, :, None], 3, axis=2))
    for path, as_gray in (("img.jpg", False), ("noise_cv2.png", True), ("missing.png", False)):
        with pytest.raises(imageio.NoImageCodecError, match="frame cache"):
            imageio.read_image(str(tmp_path / path), gray=as_gray)
    with pytest.raises(ValueError):
        imageio.encode_rgb_png(gray)
