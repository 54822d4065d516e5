"""The port's last functions against the JAX package's: the device crops
(`ops/crop.py::crop_bilinear`, `crop_nearest`), the crop-grid geometry
(`ops/geometry.py::roi_grid`, `map_crop_to_original`), the EdgeConv feature
gather (`ops/knn.py::gather_graph_feature`), the legacy code dicts
(`ops/legacy_codes.py`), the profiler scope (`utils/logging.py::profiler`)
and the small counterparts `TrainState.variables`, `InitNet.num_out_bits`;
the cases of tests/test_crop.py, test_geometry.py and test_codes.py."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.models.init_net import InitNet as FlaxInitNet
from checkerpose_tpu.ops import crop as jcrop, geometry as jgeometry, knn as jknn
from checkerpose_tpu.ops import legacy_codes as jlegacy
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.ops import crop, geometry, knn, legacy_codes
from checkerpose_tpu_torch.train.state import TrainState
from checkerpose_tpu_torch.utils.logging import profiler

BBOXES = ([40, 30, 128, 128], [-20.5, 200.3, 150.2, 150.2], [250, 180, 100, 100])


@pytest.mark.parametrize("bbox", BBOXES)
def test_device_crops_match_jax(bbox):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, size=(240, 320, 3)).astype(np.float32)
    mask = (rng.integers(0, 2, size=(240, 320)) * 255).astype(np.float32)
    b = np.array(bbox, np.float32)
    got = crop.crop_bilinear(torch.from_numpy(img), torch.from_numpy(b), 64)
    want = jcrop.crop_bilinear(jnp.asarray(img), jnp.asarray(b), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    got = crop.crop_nearest(torch.from_numpy(mask), torch.from_numpy(b), 64)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcrop.crop_nearest(jnp.asarray(mask),
                                                                jnp.asarray(b), 64)))


def test_device_crops_batched_equal_per_image():
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 60, 80, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.random((3, 60, 80)) > 0.5).astype(np.float32))
    bb = torch.tensor([[5, 6, 40, 40], [-3, 2, 50, 50], [30, 30, 60, 60.]])
    got, got_m = crop.crop_bilinear(imgs, bb, 16), crop.crop_nearest(masks, bb, 16)
    assert got.shape == (3, 16, 16, 3) and got_m.shape == (3, 16, 16)
    for i in range(3):
        torch.testing.assert_close(got[i], crop.crop_bilinear(imgs[i], bb[i], 16),
                                   rtol=0, atol=0)
        torch.testing.assert_close(got_m[i], crop.crop_nearest(masks[i], bb[i], 16),
                                   rtol=0, atol=0)
    u8 = crop.crop_bilinear(imgs.to(torch.uint8), bb, 16)
    assert u8.dtype == torch.float32


def test_device_crop_matches_host_inside_image():
    """tests/test_crop.py's cases: the device crops against the host crop."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, size=(240, 320, 3)).astype(np.float32)
    bbox = np.array([40, 30, 128, 128])
    host = crop.crop_resize_np(img, bbox, 64, "linear")
    dev = crop.crop_bilinear(torch.from_numpy(img), torch.tensor(bbox), 64).numpy()
    assert np.abs(host.astype(np.float64) - dev).max() < 1.0
    mask = (rng.integers(0, 2, size=(240, 320)) * 255).astype(np.float32)
    host = crop.crop_resize_np(mask, bbox, 64, "nearest")
    dev = crop.crop_nearest(torch.from_numpy(mask), torch.tensor(bbox), 64).numpy()
    np.testing.assert_array_equal(host, dev)       # the grids coincide at integer scales


def test_roi_grid_and_map_crop_to_original():
    grid = geometry.roi_grid(64)
    np.testing.assert_array_equal(grid, jgeometry.roi_grid(64))
    bbox = np.array([12, 34, 128, 128], dtype=np.float64)
    ori = geometry.map_crop_to_original(grid, bbox, 64)
    assert ori[0, 0, 0] == 12 and ori[0, 0, 1] == 34 and ori[0, 1, 0] == 12 + 2
    np.testing.assert_array_equal(ori, jgeometry.map_crop_to_original(grid, bbox, 64))
    t = geometry.map_crop_to_original(torch.from_numpy(grid), torch.from_numpy(bbox), 64)
    want = jgeometry.map_crop_to_original(jnp.asarray(grid), jnp.asarray(bbox, jnp.float32), 64)
    np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-6)


def test_gather_graph_feature_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 4)).astype(np.float32)
    idx = jknn.knn_index(rng.standard_normal((10, 3)), 3)
    got = knn.gather_graph_feature(torch.from_numpy(x), idx)
    want = np.asarray(jknn.gather_graph_feature(jnp.asarray(x), jnp.asarray(idx)))
    assert got.shape == (2, 10, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_legacy_corres_dict_roundtrip(tmp_path):
    """tests/test_codes.py's case, and the port's parse and coarsening equal
    JAX's."""
    p = tmp_path / "dict.txt"
    rng = np.random.default_rng(0)
    pts = {i: rng.normal(size=3) * 50 for i in range(8)}
    p.write_text("\n".join(["65536 2 16"] + [f"{i} {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
                                             for i, v in pts.items()]) + "\n")
    total, divide, iters, table = legacy_codes.load_corres_dict(str(p))
    assert (total, divide, iters) == (65536.0, 2.0, 16.0) and set(table) == set(range(8))
    np.testing.assert_allclose(table[3], pts[3], atol=1e-5)
    coarse = legacy_codes.coarsen_corres_dict(table, 13)
    assert set(coarse) == {0}
    np.testing.assert_allclose(coarse[0], np.mean([pts[i] for i in range(8)], axis=0),
                               atol=1e-5)
    jtable = jlegacy.load_corres_dict(str(p))[3]
    for bits in (13, 15, 16):
        jc = jlegacy.coarsen_corres_dict(jtable, bits)
        pc = legacy_codes.coarsen_corres_dict(table, bits)
        assert sorted(pc) == sorted(jc)
        for k in jc:
            np.testing.assert_array_equal(pc[k], jc[k])
    with pytest.raises(ValueError, match="new_bits"):
        legacy_codes.coarsen_corres_dict(table, 0)
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2\n")
    with pytest.raises(ValueError, match="header"):
        legacy_codes.load_corres_dict(str(bad))


def test_profiler_writes_a_trace(tmp_path):
    with profiler(str(tmp_path / "trace")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with profiler(None):                          # nothing written, nothing raised
        pass


def test_small_counterparts():
    """TrainState.variables and InitNet.num_out_bits as in the JAX package."""
    net = InitNet(npoint=16, res_log2=3, backbone_name="hrnet_w18_small", num_graph_module=1)
    jnet = FlaxInitNet(npoint=16, res_log2=3, backbone_name="hrnet_w18_small",
                       num_graph_module=1)
    assert net.num_out_bits == jnet.num_out_bits == 7
    st = TrainState(module=net, optimizer=None)
    v = st.variables()
    assert sorted(v) == ["batch_stats", "params"]
    assert set(v["params"]) == {k for k, _ in net.named_parameters()}
    assert set(v["batch_stats"]) == {k for k, _ in net.named_buffers()}
    assert all(k.endswith(("running_mean", "running_var")) for k in v["batch_stats"])
    assert v["params"]["mlp.weight"] is net.mlp.weight
