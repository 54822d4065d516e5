"""NOCS backbone pretraining in the port (ops/raster.py, train/steps.py::
nocs_labels and make_nocs_train_step, models/nocs.py, cli/pretrain_backbone.py
and its graft) against the JAX package on the CPU, mirroring
tests/test_raster.py and tests/test_nocs.py; and a rehearsal of
chip_smoke.py's phase backbones at tiny size."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from checkerpose_tpu.models.nocs import NOCSNet as FlaxNOCSNet
from checkerpose_tpu.ops import raster as jraster
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.cli import pretrain_backbone as cli_nocs
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.eval.renderer import render_depth
from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.nocs import NOCSNet
from checkerpose_tpu_torch.ops import raster
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import TrainState, create_init_state, make_optimizer
from test_raster import crop_K, icosphere, rand_pose
from torch_parity import few_torch_threads, load_port, random_variables  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float64)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)        # tests/test_torch_train_steps.py's, for a step


def _posed_batch(verts, B, rng, S):
    Rs, ts, bbs = [], [], []
    for _ in range(B):
        Q, t = rand_pose(rng)
        uv = verts @ Q.T + t
        uv = (uv[:, :2] / uv[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        x0, y0 = uv.min(0) - 8
        side = float(max(*(uv.max(0) - uv.min(0) + 16)))
        Rs.append(Q), ts.append(t), bbs.append([x0, y0, side, side])
    return (np.asarray(Rs, np.float32), np.asarray(ts, np.float32),
            np.tile(K.astype(np.float32), (B, 1, 1)), np.asarray(bbs, np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_raster_matches_jax_and_the_host_z_buffer():
    verts, faces = icosphere()
    S = 64
    R, t, Kb, bb = _posed_batch(verts, 3, np.random.default_rng(0), S)
    want = np.asarray(jraster.render_depth_crops(verts, faces, *map(jnp.asarray, (R, t, Kb, bb)),
                                                 S))
    got = raster.render_depth_crops(verts, faces, *_t(R, t, Kb, bb), S).numpy()
    assert got.shape == want.shape == (3, S, S) and got.dtype == np.float32
    hit_g, hit_w = got > 0, want > 0
    assert (hit_g ^ hit_w).sum() <= 3             # edge ties only
    both = hit_g & hit_w
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5)
    for i in range(3):                            # tests/test_raster.py's bars
        host = render_depth(verts, faces, R[i].astype(np.float64), t[i].astype(np.float64),
                            crop_K(K, bb[i], S), S, S)
        h = host > 0
        assert (hit_g[i] ^ h).mean() < 0.02 and (hit_g[i] & h).sum() > 200
        err = np.abs(got[i][hit_g[i] & h] - host[hit_g[i] & h]) / host[hit_g[i] & h]
        assert np.quantile(err, 0.99) < 5e-3


def test_raster_groups_and_chunks_do_not_change_the_result(monkeypatch):
    """Samples rendered one group at a time, faces passed as chunks."""
    verts, faces = icosphere(n=8)
    R, t, Kb, bb = _t(*_posed_batch(verts, 3, np.random.default_rng(1), 32))
    whole = raster.render_depth_crops(verts, faces, R, t, Kb, bb, 32)
    monkeypatch.setattr(raster, "_MAX_ELEMS", raster._CHUNK * 32 * 32)
    one_by_one = raster.render_depth_crops(verts, raster.face_chunks(faces), R, t, Kb, bb, 32)
    assert torch.equal(whole, one_by_one)


def test_raster_dummy_bbox_and_intrinsics():
    verts, faces = icosphere(n=6)
    bb = np.zeros((1, 4), np.float32)
    args = (np.eye(3, dtype=np.float32)[None], np.array([[0., 0., 400.]], np.float32),
            K.astype(np.float32)[None], bb)
    out = raster.render_depth_crops(verts, faces, *_t(*args), 16).numpy()
    want = np.asarray(jraster.render_depth_crops(verts, faces, *map(jnp.asarray, args), 16))
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, want)
    bbs = np.array([[280., 200., 90., 90.], [0., 0., 0., 0.], [10., 20., 33., 47.]], np.float32)
    Ks = np.tile(K.astype(np.float32), (3, 1, 1))
    got = raster.crop_intrinsics(*_t(Ks, bbs), 64)
    want = jraster.crop_intrinsics(jnp.asarray(Ks), jnp.asarray(bbs), 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_raster_occlusion_front_surface():
    verts = np.array([[-20, -20, 0], [20, -20, 0], [20, 20, 0], [-20, 20, 0],
                      [-20, -20, 30], [20, -20, 30], [20, 20, 30], [-20, 20, 30]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    out = raster.render_depth_crops(
        verts, faces, *_t(np.eye(3, dtype=np.float32)[None], np.array([[0, 0, 400]], np.float32),
                          K.astype(np.float32)[None], np.array([[280., 200., 90., 90.]],
                                                               np.float32)), 32)[0].numpy()
    hit = out > 0
    assert hit.sum() > 100
    np.testing.assert_allclose(out[hit], 400.0, rtol=1e-5)


def test_nocs_labels_match_jax_and_round_trip():
    """tests/test_nocs.py's round trip, and the port against JAX's labels."""
    from checkerpose_tpu.ops import geometry
    rng = np.random.default_rng(0)
    S, diameter = 64, 100.0
    m = rng.uniform(-40, 40, (200, 3))
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    Q[:, 0] *= np.sign(np.linalg.det(Q))
    t = np.array([5.0, -10.0, 400.0])
    cam = m @ Q.T + t
    uv, _ = geometry.project_pts(m, K, Q, t)
    x0, y0 = uv.min(0) - 5
    side = float(max(*(uv.max(0) - uv.min(0) + 10)))
    bbox = geometry.square_bbox(np.array([x0, y0, side, side])).astype(np.float64)
    xi = np.clip(((uv[:, 0] - bbox[0]) / (bbox[2] / S)).astype(int), 0, S - 1)
    yi = np.clip(((uv[:, 1] - bbox[1]) / (bbox[3] / S)).astype(int), 0, S - 1)
    _, first, counts = np.unique(yi * S + xi, return_index=True, return_counts=True)
    keep = np.zeros(len(m), bool)
    keep[first[counts == 1]] = True
    m, cam, xi, yi = m[keep], cam[keep], xi[keep], yi[keep]
    depth = np.zeros((1, S, S), np.float32)
    depth[0, yi, xi] = cam[:, 2]
    args = (depth, (depth > 0).astype(np.float32), bbox[None].astype(np.float32),
            K[None].astype(np.float32), Q[None].astype(np.float32), t[None].astype(np.float32))
    nocs, valid = steps.nocs_labels(*_t(*args), diameter)
    jn, jv = jsteps.nocs_labels(*map(jnp.asarray, args), diameter)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(nocs.numpy(), np.asarray(jn), atol=1e-6)
    nocs, valid = nocs.numpy()[0], valid.numpy()[0]
    assert valid.sum() >= 100
    tol = 0.75 * (bbox[2] / S) * (cam[:, 2].max() / K[0, 0]) / diameter
    err = np.abs(nocs[yi, xi] - (m / diameter + 0.5))[valid[yi, xi] > 0.5]
    assert err.max() < max(tol, 0.02)


def test_nocs_labels_invalid_pixels():
    S = 8
    nocs, valid = steps.nocs_labels(torch.zeros(1, S, S), torch.ones(1, S, S),
                                    torch.tensor([[10., 10., 64., 64.]]),
                                    torch.from_numpy(K.astype(np.float32))[None],
                                    torch.eye(3)[None], torch.tensor([[0., 0., 300.]]), 100.0)
    assert float(valid.sum()) == 0.0 and torch.isfinite(nocs).all()


@pytest.fixture(scope="module")
def tiny_nocs():
    """resnet34 NOCSNet, head 16, f32, at 64x64: Flax variables with
    perturbed BN statistics and the port's module loaded from them."""
    fnet = FlaxNOCSNet(backbone_name="resnet34", head_width=16, dtype=jnp.float32)
    v = random_variables(fnet, jnp.zeros((1, 64, 64, 3)), train=False, bn_scale=(0.3, 0.6))
    return fnet, v


def test_nocsnet_forward_matches_jax(tiny_nocs):
    fnet, v = tiny_nocs
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(fnet.apply(v, jnp.asarray(x), train=False))
    net = load_port(NOCSNet("resnet34", 16, dtype=torch.float32), v)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 4)
    assert (out[..., :3] >= 0).all() and (out[..., :3] <= 1).all()
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_nocs_step_matches_jax(tiny_nocs):
    """One step from the same weights and batch, augmentation off, depth
    rendered from the mesh on both sides: loss terms to a step's tolerance,
    gradients (JAX's through optax.sgd(1.0)) to 1e-3 relative L2 (no
    EdgeConv, so no max over neighbours reroutes them), BN statistics."""
    fnet, v = tiny_nocs
    verts, faces = icosphere()
    rng = np.random.default_rng(5)
    R, t, Kb, bb = _posed_batch(verts, 2, rng, 16)
    batch = {"image": rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
             "mask_visib": (rng.random((2, 16, 16)) > 0.3).astype(np.float32),
             "bbox": bb, "cam_K": Kb, "R": R, "t": t}
    opt = optax.sgd(1.0)
    jstep = jsteps.make_nocs_train_step(fnet, opt, diameter=80.0, use_pepper_salt=False,
                                        use_motion_blur=False, color_aug_prob=0.0,
                                        mesh=(verts, faces))
    params = jax.tree.map(np.asarray, v["params"])
    new, jm = jstep({"params": jax.tree.map(jnp.array, params),
                     "batch_stats": jax.tree.map(jnp.array, v["batch_stats"]),
                     "opt_state": opt.init(params)}, batch, jax.random.PRNGKey(0))
    grads = flax_to_torch({"params": jax.tree.map(lambda p, q: p - np.asarray(q), params,
                                                  new["params"])})
    stats = flax_to_torch({"batch_stats": jax.tree.map(np.asarray, new["batch_stats"])})

    net = load_port(NOCSNet("resnet34", 16, dtype=torch.float32), v)
    state = create_init_state(net, make_optimizer(0.0), seed=None, device="cpu")
    step = steps.make_nocs_train_step(net, diameter=80.0, use_pepper_salt=False,
                                      use_motion_blur=False, color_aug_prob=0.0,
                                      mesh=(verts, faces))
    m = step(state, {k: torch.from_numpy(a) for k, a in batch.items()}, torch.Generator())
    assert sorted(m) == sorted(jm) == ["loss", "loss_nocs", "loss_visib"]
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL, err_msg=k)
    assert float(m["loss_nocs"]) > 0.0 and state.step == 1
    num = den = 0.0
    for name, p in net.named_parameters():
        num += float((p.grad - grads[name]).norm()) ** 2
        den += float(grads[name].norm()) ** 2
    assert (num / den) ** 0.5 < 1e-3
    own = net.state_dict()
    for k, want in stats.items():
        np.testing.assert_allclose(own[k].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _fixture(tmp_path):
    root = tmp_path / "data"
    make_synthetic_bop(str(root), n_objects=1, n_scenes=1, folders={"test": 4, "train_real": 4},
                       n_vertices=64, raw_cache=True, write_png=False)
    return str(root)


NOCS_SMALL = dict(network_backbone_name="resnet34", nocs_head_width=16, batch_size=2,
                  BoundingBox_CropSize_image=64, num_p3d_log2=4, learning_rate=1e-3)


def test_pretrain_backbone_cli_and_graft(tmp_path, capsys, monkeypatch):
    """cli.pretrain_backbone for 2 iterations on the CPU; its checkpoint's
    backbone grafts into a resnet34 InitNet bit for bit (head and graph
    untouched, nothing at a resumed step); a missing checkpoint warns, or
    raises under CHECKERPOSE_REQUIRE_BACKBONE_GRAFT=1."""
    data = _fixture(tmp_path)
    cfg = common.resolve_cfg("config/synth/nocs_backbone_synth.txt", "obj01", dict(
        NOCS_SMALL, bop_path=data, check_point_path=str(tmp_path / "ck"),
        tensorboard_path=str(tmp_path / "tb"), total_iteration=2, log_freq=1, device="cpu"))
    args = cli_nocs.parse_args(["--cfg", "c.txt", "--obj_name", "obj01", "--device", "cpu",
                                "--total_iteration", "2"])
    assert (args.device, args.total_iteration, args.save_freq) == ("cpu", 2, None)
    state = cli_nocs.main(cfg)
    out = capsys.readouterr().out
    assert state.step == 2 and "step 2/2" in out
    ck = cfg["check_point_path"]
    raw = CheckpointManager(ck).restore_raw()
    src = {k[len("backbone."):]: v for k, v in raw["model"].items() if k.startswith("backbone.")}
    assert src and "head_out.weight" in raw["model"]

    init = InitNet(npoint=16, res_log2=3, backbone_name="resnet34", num_graph_module=1,
                   dtype=torch.float32)
    st = create_init_state(init, make_optimizer(1e-3), device="cpu")
    before = {k: v.clone() for k, v in init.state_dict().items()}
    g = common.maybe_graft_pretrained_backbone({"backbone_pretrain_checkpoint": ck}, st)
    after = g.module.state_dict()
    assert "grafted NOCS-pretrained backbone" in capsys.readouterr().out
    for k, v in after.items():
        want = src[k[len("backbone."):]] if k.startswith("backbone.") else before[k]
        assert torch.equal(v, want), k
    resumed = TrainState(module=init, optimizer=st.optimizer, step=5)
    assert common.maybe_graft_pretrained_backbone({"backbone_pretrain_checkpoint": ck},
                                                  resumed) is resumed

    missing = {"backbone_pretrain_checkpoint": str(tmp_path / "does_not_exist")}
    assert common.maybe_graft_pretrained_backbone(missing, st) is st
    assert "training the backbone from scratch" in capsys.readouterr().out
    monkeypatch.setenv("CHECKERPOSE_REQUIRE_BACKBONE_GRAFT", "1")
    with pytest.raises(FileNotFoundError):
        common.maybe_graft_pretrained_backbone(missing, st)


def test_pretrain_backbone_refuses_a_mesh_without_faces(tmp_path):
    data = _fixture(tmp_path)
    from checkerpose_tpu_torch.data.ply import load_ply_mesh, save_ply_vertices
    path = f"{data}/synth/models/obj_000001.ply"
    save_ply_vertices(path, load_ply_mesh(path)[0])
    cfg = common.resolve_cfg("config/synth/nocs_backbone_synth.txt", "obj01", dict(
        NOCS_SMALL, bop_path=data, check_point_path=str(tmp_path / "ck"),
        tensorboard_path=str(tmp_path / "tb"), total_iteration=1, device="cpu"))
    with pytest.raises(ValueError, match="no faces"):
        cli_nocs.main(cfg)


def test_chip_smoke_backbones_phase_rehearsed_on_cpu(tmp_path):
    """phase_backbones at tiny size on the CPU: every gate runs, no kernel
    launches off the card, and no device number is made up."""
    small = dict(num_p3d_log2=4, network_graph_k=5, init_network_graph_k=5, batch_size=2)
    res = chip_smoke.phase_backbones(
        torch.device("cpu"), batch=2, npoint=32, iters=1, other_backbones=("hrnet_w18_small",),
        other_batch=2,
        timm_backbones=("resnet34",), timm_batch=1, root=tmp_path, n_test=2, n_train=4,
        n_scenes=1, n_vertices=64, nocs_iters=6, graft_iters=1, eval_batch=2,
        n_host_renders=2, nocs_overrides=NOCS_SMALL,
        pretrain_overrides=dict(small, network_backbone_name="resnet34"),
        eval_overrides=small)
    assert sorted(res["serving"]) == ["hrnet_w18_small", "resnet34"]
    assert res["serving"]["resnet34"]["crops_per_s"] is None
    assert res["serving"]["resnet34"]["vs_hrnet_w18"] is None
    assert res["reference"]["resnet34"]["f32"]["x_id"] == 1.0
    assert res["timm"]["resnet34"]["entries"] == 180
    assert res["fixture"]["generated"] and res["fixture"]["seconds"] is None
    nocs = res["nocs"]
    assert len(nocs["logged_losses"]) == 6 and nocs["ms_per_iter"] is None
    assert nocs["raster_device_ms_per_batch"] is None and nocs["label_max_abs_err"] < 1e-4
    assert nocs["peak_mem_gib"] is None and nocs["S"] == 16
    assert res["nocs_graft"]["entries"] == 180
    assert res["test_cli"]["images_per_s"] is None and res["test_cli"]["forward_batches"] == 1
    for path, by_route in res["launches_by_path"].items():
        assert by_route == {"tc": 0, "fma": 0}, path
    assert res["seconds"] is None
