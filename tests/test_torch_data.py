"""The port's host data layer against the JAX package's: config presets, the
BOP index (samples, detections, models_info, FPS points), bbox helpers, the
numpy crop against cv2, CropDataset items, the Loader, the frame cache and
the synthetic fixture generator; and the whole data path with no image
codec importable. Small fixtures on the CPU."""
import json
import os
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from checkerpose_tpu import config as jconfig
from checkerpose_tpu.data import bop_io as jbop, detections as jdet, fps as jfps
from checkerpose_tpu.data import dataset as jdataset, framestore as jframes, ply as jply
from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu.ops import crop as jcrop, geometry as jgeom
from checkerpose_tpu_torch import config as pconfig
from checkerpose_tpu_torch.data import bop_io as pbop, detections as pdet, fps as pfps
from checkerpose_tpu_torch.data import dataset as pdataset, framestore as pframes, ply as pply
from checkerpose_tpu_torch.data.dataset_info import get_obj_info
from checkerpose_tpu_torch.data.imageio import NoImageCodecError
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.ops import crop as pcrop, geometry as pgeom

ROOT = Path(__file__).resolve().parent.parent
NPT = 32


def _assert_image_close(a, b):
    """The numpy bilinear against cv2.resize on uint8: within 1 grey level,
    >= 99% of values exact (cv2 rounds in 11-bit fixed point, SIMD paths)."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert a.shape == b.shape and a.dtype == b.dtype
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    """A dataset written by the JAX package's generator: PNGs and a frame cache."""
    root = tmp_path_factory.mktemp("jax_synth")
    jax_make_synthetic_bop(str(root), n_objects=2, n_scenes=2, n_images=4,
                           n_vertices=100, raw_cache=True)
    return str(root)


def _samples(mod, root, **kw):
    return mod.scan_bop_object(root, "synth", "test", 1, **kw)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in ROOT.glob("config/**/*.txt")))
def test_config_presets_parse_equal(path):
    assert pconfig.parse_cfg(str(ROOT / path)) == jconfig.parse_cfg(str(ROOT / path))


def test_stage_helpers():
    cfg = {"stage_start_steps_str": "0_100_250"}
    assert pconfig.stage_start_steps(cfg) == jconfig.stage_start_steps(cfg) == (0, 100, 250)
    assert pconfig.stage_start_steps({}) is None
    for step in (0, 99, 100, 300):
        assert pconfig.get_train_stage(step, (0, 100, 250)) == \
            jconfig.get_train_stage(step, (0, 100, 250))
    names, syms = get_obj_info("lmo")
    assert names["ape"] == 1 and "eggbox" in syms
    with pytest.raises(ValueError):
        get_obj_info("nope")


def _same_sample(a, b):
    for field in a.__dataclass_fields__:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=field)
        else:
            assert va == vb, field


def test_index_samples_detections_models(jax_fixture):
    root = jax_fixture
    for kw in ({}, {"visib_threshold": -1.0}):
        js, ps = _samples(jbop, root, **kw), _samples(pbop, root, **kw)
        assert len(js) == len(ps) == 4
        for a, b in zip(js, ps):
            _same_sample(a, b)
    for a, b in zip(jbop.scan_bop_targets(root, "synth", 2), pbop.scan_bop_targets(root, "synth", 2)):
        _same_sample(a, b)
    assert pbop.load_models_info(root, "synth") == jbop.load_models_info(root, "synth")
    assert pbop.model_ply_path(root, "synth", 1, True) == jbop.model_ply_path(root, "synth", 1, True)
    det_path = os.path.join(root, "detection_results", "synth", "synth_detections.json")
    jd, pd = jdet.load_detections(det_path, 1), pdet.load_detections(det_path, 1)
    assert sorted(jd) == sorted(pd)
    for k in jd:
        np.testing.assert_array_equal(jd[k][0], pd[k][0])
        assert jd[k][1] == pd[k][1]
    js = jdet.attach_detections(_samples(jbop, root), jd)
    ps = pdet.attach_detections(_samples(pbop, root), pd)
    for a, b in zip(js, ps):
        _same_sample(a, b)
    del pd[(0, 0)]
    assert pdet.detection_scores(pd, ps)[0] == -1.0
    assert [s.im_id for s in pdet.ycbv_select_keyframe(pd, ps)] == \
        [s.im_id for s in jdet.ycbv_select_keyframe(pd, js)]


def test_ply_and_fps_points(jax_fixture, tmp_path):
    root = jax_fixture
    ply = pbop.model_ply_path(root, "synth", 1)
    for a, b in zip(jply.load_ply_mesh(ply), pply.load_ply_mesh(ply)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jfps.load_keypoints_normed(root, "synth", 1, NPT),
                    pfps.load_keypoints_normed(root, "synth", 1, NPT)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pfps.load_fps_points(root, "synth", 1, 1000)
    ja, pa = jfps.generate_fps_keypoints(ply, 5), pfps.generate_fps_keypoints(ply, 5)
    np.testing.assert_array_equal(ja["id"], pa["id"])
    pfps.save_fps_pkl(pa, str(tmp_path / "x" / "obj.pkl"))
    verts = np.random.default_rng(0).standard_normal((20, 3))
    pply.save_ply_vertices(str(tmp_path / "v.ply"), verts, np.array([[0, 1, 2, 3]]))
    got_v, got_f = jply.load_ply_mesh(str(tmp_path / "v.ply"))
    np.testing.assert_allclose(got_v, verts, rtol=1e-6)
    np.testing.assert_array_equal(got_f, [[0, 1, 2], [0, 2, 3]])


def test_bbox_helpers_and_projection():
    rng = np.random.default_rng(3)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]])
    for _ in range(50):
        bbox = np.array([rng.uniform(-40, 600), rng.uniform(-40, 400),
                         rng.uniform(5, 300), rng.uniform(5, 300)])
        ratio = rng.uniform(1.0, 2.0)
        np.testing.assert_array_equal(pgeom.padding_bbox(bbox, ratio),
                                      jgeom.padding_bbox(bbox, ratio))
        np.testing.assert_array_equal(pgeom.aug_bbox(bbox, ratio, np.random.default_rng(7)),
                                      jgeom.aug_bbox(bbox, ratio, np.random.default_rng(7)))
        for method in ("crop_square_resize", "crop_resize_by_warp_affine", "crop_resize"):
            np.testing.assert_array_equal(pgeom.final_bbox(bbox, method, 640, 480),
                                          jgeom.final_bbox(bbox, method, 640, 480))
    with pytest.raises(NotImplementedError):
        pgeom.final_bbox(bbox, "warp", 640, 480)
    pts = rng.uniform(-40, 40, (30, 3))
    R, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    t = np.array([5.0, -3.0, 450.0])
    for a, b in zip(pgeom.project_pts(pts, K, R, t), jgeom.project_pts(pts, K, R, t)):
        np.testing.assert_array_equal(a, b)
    for center in (True, False):
        np.testing.assert_array_equal(pgeom.farthest_point_sample(pts, 10, center),
                                      jgeom.farthest_point_sample(pts, 10, center))


@pytest.mark.parametrize("side", [17, 100, 256, 301, 512, 700])
def test_crop_resize_matches_cv2(side):
    """Linear crops of a few sizes (up, equal, exact 2x down, down) within
    1 level of cv2 and >= 99% exact; nearest crops of masks exact."""
    rng = np.random.default_rng(side)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    mask = (rng.random((480, 640)) > 0.5).astype(np.uint8) * 255
    for bbox in ([20, 30, side, side], [600 - side // 2, -10, side, side // 2 + 1],
                 [-5, 400, side // 2 + 8, side]):
        for method in ("crop_square_resize", "crop_resize"):
            _assert_image_close(pcrop.get_roi_np(img, bbox, 256, "linear", method),
                                jcrop.get_roi_np(img, bbox, 256, "linear", method))
            np.testing.assert_array_equal(pcrop.get_roi_np(mask, bbox, 64, "nearest", method),
                                          jcrop.get_roi_np(mask, bbox, 64, "nearest", method))
    with pytest.raises(NotImplementedError):
        pcrop.get_roi_np(img, [0, 0, 9, 9], 8, "linear", "warp")
    f = rng.random((37, 53)).astype(np.float32)
    np.testing.assert_allclose(pcrop._resize_np(f, 64, "linear"),
                               cv2.resize(f, (64, 64), interpolation=cv2.INTER_LINEAR),
                               atol=1e-5)


def _datasets(root, use_det, is_train, cache):
    det_path = os.path.join(root, "detection_results", "synth", "synth_detections.json")
    xyz = jfps.load_fps_points(root, "synth", 1, NPT)
    out = []
    for bop, det, dataset, frames in ((jbop, jdet, jdataset, jframes),
                                      (pbop, pdet, pdataset, pframes)):
        samples = bop.scan_bop_object(root, "synth", "test", 1)
        if use_det:
            samples = det.attach_detections(samples, det.load_detections(det_path, 1))
            samples[1].detect_bbox = None                # a missed detection: a dummy item
        fc = frames.FrameCache(os.path.join(root, "synth", "frame_cache")) if cache else None
        # both on the python path (the native core's parity has its own tests)
        kw = dict(is_train=is_train, crop_size_gt=64, use_detections=use_det, seed=5,
                  frame_cache=fc, use_native=False)
        out.append(dataset.CropDataset(samples, xyz, **kw))
    return out


@pytest.mark.parametrize("use_det,is_train,cache", [(False, False, False), (True, False, True),
                                                     (False, True, True)])
def test_crop_dataset_items(jax_fixture, use_det, is_train, cache):
    jds, pds = _datasets(jax_fixture, use_det, is_train, cache)
    assert len(jds) == len(pds)
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        assert sorted(a) == sorted(b)
        _assert_image_close(b["image"], a["image"])
        for k in a:
            if k != "image":
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert b[k].dtype == a[k].dtype, k
    if use_det:
        assert pds[1]["valid"] == 0.0


@pytest.mark.parametrize("shuffle,drop_last,batch", [(False, False, 3), (True, True, 3),
                                                     (False, False, 4)])
def test_loader_batches_padding_n_real(jax_fixture, shuffle, drop_last, batch):
    jds, pds = _datasets(jax_fixture, False, False, True)
    jl = jdataset.Loader(jds, batch, shuffle=shuffle, drop_last=drop_last, seed=2)
    pl = pdataset.Loader(pds, batch, shuffle=shuffle, drop_last=drop_last, seed=2)
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == (1 if drop_last or batch == 4 else 2)
    for a, b in zip(jb, pb):
        assert sorted(a) == sorted(b)
        assert int(a["n_real"]) == int(b["n_real"])
        for k in a:
            if k != "image":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if batch == 3 and not drop_last:
        # 4 samples, (scene, im) (0, 0) (0, 2) (1, 0) (1, 2): the last batch
        # holds 1 real row and 2 rows of padding from the start of the order
        assert int(pb[-1]["n_real"]) == 1
        np.testing.assert_array_equal(pb[-1]["scene_id"], [1, 0, 0])
        np.testing.assert_array_equal(pb[-1]["im_id"], [2, 0, 2])
    assert pdataset.mixed_batch_sizes(8, 0.75) == jdataset.mixed_batch_sizes(8, 0.75) == (2, 6)
    mixed = list(pdataset.MixedLoader(pdataset.Loader(pds, 1, shuffle=False),
                                      pdataset.Loader(pds, 2, shuffle=False)))
    assert len(mixed) == 2 and mixed[0]["image"].shape[0] == 3 and int(mixed[0]["n_real"]) == 3


def test_train_loaders_match_jax(jax_fixture):
    """cli/common.py::build_train_loaders on both packages (two folders mixed
    at 0.75, frame cache): the first mixed batches equal but for the image,
    and the validation factory's batches equal."""
    from checkerpose_tpu.cli import common as jcommon
    from checkerpose_tpu_torch.cli import common as pcommon
    cfg = dict(bop_path=jax_fixture, dataset_name="synth", obj_id=1, batch_size=4,
               training_data_folder="train_real", training_data_folder_2="train_pbr",
               second_dataset_ratio=0.75, val_folder="test", BoundingBox_CropSize_GT=64)
    xyz = jfps.load_fps_points(jax_fixture, "synth", 1, NPT)
    (jtrain, jval), (ptrain, pval) = (jcommon.build_train_loaders(cfg, xyz, seed=3),
                                      pcommon.build_train_loaders(cfg, xyz, seed=3))
    jit, pit = iter(jtrain), iter(ptrain)
    for pair in ((next(jit), next(pit)), (next(jit), next(pit)), *zip(jval(), pval())):
        a, b = pair
        assert sorted(a) == sorted(b) and int(a["n_real"]) == int(b["n_real"])
        _assert_image_close(b["image"], a["image"])
        for k in a:
            if k != "image":
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_loader_raises_a_worker_error():
    class Broken:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise KeyError("broken item")

    with pytest.raises(KeyError, match="broken item"):
        list(pdataset.Loader(Broken(), 1, shuffle=False))


def test_frame_cache_written_by_jax_reads_back(jax_fixture, tmp_path):
    root = jax_fixture
    jc = jframes.FrameCache(os.path.join(root, "synth", "frame_cache"))
    pc = pframes.FrameCache(os.path.join(root, "synth", "frame_cache"))
    assert pc.hw == jc.hw and pc.frame_index == jc.frame_index
    for s in _samples(pbop, root):
        png = cv2.imread(s.rgb_path)[:, :, ::-1]
        np.testing.assert_array_equal(pc.get_frame(s.rgb_path), png)
        np.testing.assert_array_equal(pc.get_mask(s.mask_visib_path), jc.get_mask(s.mask_visib_path))
    assert pc.get_frame("/nowhere.png") is None
    # a cache built from the PNGs by the port equals one built by the JAX package
    samples = _samples(pbop, root)
    built_p = pframes.build_frame_cache(samples, str(tmp_path / "p"))
    built_j = jframes.build_frame_cache(samples, str(tmp_path / "j"))
    for s in samples:
        np.testing.assert_array_equal(built_p.get_frame(s.rgb_path), built_j.get_frame(s.rgb_path))
        np.testing.assert_array_equal(built_p.get_mask(s.mask_path), built_j.get_mask(s.mask_path))


def test_generator_matches_jax(jax_fixture, tmp_path):
    """Same seed, same sizes: GT poses and cameras equal, bboxes within 1 px,
    masks >= 99.5% equal over the union of their foregrounds; models, FPS
    points and the targets equal."""
    proot = str(tmp_path)
    make_synthetic_bop(proot, n_objects=2, n_scenes=2, n_images=4, n_vertices=100,
                       raw_cache=True)
    jroot = jax_fixture
    for folder in ("train_real", "train_pbr", "test"):
        for scene in ("000000", "000001"):
            d = os.path.join("synth", folder, scene)
            for name in ("scene_gt.json", "scene_camera.json"):
                with open(os.path.join(jroot, d, name)) as fj, \
                        open(os.path.join(proot, d, name)) as fp:
                    assert json.load(fj) == json.load(fp), (d, name)
            with open(os.path.join(jroot, d, "scene_gt_info.json")) as f:
                ji = json.load(f)
            with open(os.path.join(proot, d, "scene_gt_info.json")) as f:
                pi = json.load(f)
            for im in ji:
                for key in ("bbox_visib", "bbox_obj"):
                    assert np.abs(np.subtract(ji[im][0][key], pi[im][0][key])).max() <= 1
                name = f"{int(im):06d}_000000.png"
                mj = cv2.imread(os.path.join(jroot, d, "mask", name), 0)
                mp = cv2.imread(os.path.join(proot, d, "mask", name), 0)
                union = (mj > 0) | (mp > 0)
                assert (mj == mp)[union].mean() >= 0.995
    for rel in ("synth/models/models_info.json", "synth/test_targets_bop19.json"):
        with open(os.path.join(jroot, rel)) as fj, open(os.path.join(proot, rel)) as fp:
            assert json.load(fj) == json.load(fp)
    for obj in (1, 2):
        for a, b in zip(jfps.load_keypoints_normed(jroot, "synth", obj, NPT),
                        pfps.load_keypoints_normed(proot, "synth", obj, NPT)):
            np.testing.assert_array_equal(a, b)
    det = "detection_results/synth/synth_detections.json"
    with open(os.path.join(jroot, det)) as fj, open(os.path.join(proot, det)) as fp:
        jd, pd = json.load(fj), json.load(fp)
    assert sorted(jd) == sorted(pd)
    for k in jd:
        assert np.abs(np.subtract(jd[k][0]["bbox_est"], pd[k][0]["bbox_est"])).max() <= 1


def test_data_path_without_an_image_codec(monkeypatch, tmp_path):
    """cv2 and PIL unimportable: the generator writes the frame cache only,
    CropDataset reads everything from it, and a frame outside the cache
    raises an error that names the cache."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    root = str(tmp_path)
    make_synthetic_bop(root, n_objects=1, n_scenes=1, n_images=3, n_vertices=100)
    assert not os.listdir(os.path.join(root, "synth", "test", "000000", "rgb"))
    samples = pbop.scan_bop_object(root, "synth", "test", 1)
    xyz = pfps.load_fps_points(root, "synth", 1, NPT)
    cache = pframes.FrameCache(os.path.join(root, "synth", "frame_cache"))
    ds = pdataset.CropDataset(samples, xyz, is_train=False, frame_cache=cache)
    batch = next(iter(pdataset.Loader(ds, 2, shuffle=False)))
    assert batch["image"].shape == (2, 256, 256, 3) and batch["valid"].all()
    assert batch["mask_visib"].max() == 1.0
    with pytest.raises(NoImageCodecError, match="frame cache"):
        pdataset.CropDataset(samples, xyz, is_train=False)[0]
