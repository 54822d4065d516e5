"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py).
Importing this module needs no jax, so card-only tests can use it.

Both sides get the same numpy inputs made from a seed. Flax variables are
built with the module's own init tree (jax.eval_shape, no compile) and filled
from numpy, then carried into the port with models/convert.py.
"""
import math

import numpy as np
import pytest
import torch

from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.solver.ransac import solve_poses_batched as port_solve

N_HYP = 16    # hypotheses of the stand-in solver


def random_variables(module, *args, seed: int = 0, bn_scale=(0.5, 1.5), **kwargs):
    """Variables with `module.init`'s tree: kernels ~ N(0, 1/fan_in), small
    random biases and BN means, BN and LayerNorm scale uniform in `bn_scale`
    (lower it to keep a deep net's activations O(1)), BN var uniform in
    [0.5, 1.5], ConvNeXt's layer scale `gamma` uniform in [0.5, 1] (at
    Flax's init, 1e-6, every block is the identity and a parity test would
    not see its layers)."""
    import jax
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) / math.sqrt(np.prod(s.shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(s.shape)
        elif name == "scale":
            v = rng.uniform(*bn_scale, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "gamma":
            v = rng.uniform(0.5, 1.0, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load converted Flax variables into a port module (strict) in eval mode."""
    module.load_state_dict(flax_to_torch(variables), strict=True)
    return module.eval()


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def few_torch_threads():
    """At most two intra-op threads for the module's tests. The suite runs
    with several pytest-xdist workers; each worker's torch pool defaults to
    one thread per core, and with the cores oversubscribed that many times
    over an eager train step through a backbone takes ten times as long (the
    OpenMP threads spin on each other). A test module that trains takes this
    fixture with `pytestmark = pytest.mark.usefixtures("few_torch_threads")`."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def require_cuda():
    """Skip the calling test when no CUDA device is present (decided at run
    time, so every pytest-xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# LM's camera (the solver tests' intrinsics)
LM_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1.0]], np.float32)


def random_rotation(rng):
    """A uniform-ish rotation from the QR of a Gaussian matrix, det +1."""
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def pnp_problems(B, N, seed, noise=0.5, outliers=0.0):
    """B random well-posed PnP problems under LM_K: points in a 80-unit box
    at depth 350-500, pixel noise, a share of gross outliers, random
    validity. Returns f32 (p3d, p2d, valid, w) and the true (R, t)."""
    rng = np.random.default_rng(seed)
    p3d = rng.uniform(-40, 40, (B, N, 3))
    Rs = np.stack([random_rotation(rng) for _ in range(B)])
    ts = np.stack([rng.uniform(-20, 20, B), rng.uniform(-20, 20, B),
                   rng.uniform(350, 500, B)], -1)
    cam = np.einsum("bij,bnj->bni", Rs, p3d) + ts[:, None]
    uv = (cam @ LM_K.T.astype(np.float64))
    uv = uv[..., :2] / uv[..., 2:3] + noise * rng.standard_normal((B, N, 2))
    bad = rng.random((B, N)) < outliers
    uv[bad] += rng.uniform(-80, 80, (int(bad.sum()), 2))
    valid = (rng.random((B, N)) > 0.1).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (B, N)).astype(np.float32) * valid
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(p3d), f32(uv), valid, w, Rs, ts


def rot_deg(Ra, Rb):
    """Angle in degrees between rotations (..., 3, 3), in float64."""
    Ra, Rb = np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)
    cos = (np.trace(Ra @ np.swapaxes(Rb, -1, -2), axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def standin_solver(p3d, p2d, valid, K, _draws, device=None, **kw):
    """A deterministic `solve_poses_batched` for both packages' harnesses
    (monkeypatched into each harness module): the port's solver on the CPU
    with hypothesis indices fixed by the shapes; jnp arrays back to the JAX
    harness, tensors to the port's."""
    as_np = (lambda a: a.cpu().numpy()) if isinstance(p2d, torch.Tensor) else np.array
    B, N = p2d.shape[:2]
    hyp = np.argsort(np.random.default_rng(N).random((B, N_HYP, N)), -1)[..., :6]
    kw.pop("num_hyp", None)
    sol = port_solve(as_np(p3d), as_np(p2d), as_np(valid), as_np(K), hyp_idx=hyp,
                     device="cpu", **kw)
    if isinstance(p2d, torch.Tensor):
        return sol
    import jax.numpy as jnp
    return {k: jnp.asarray(v.numpy()) for k, v in sol.items()}


def assert_reports_equal(a, b):
    """JAX report a against port report b: same keys, same numbers (f32
    summation order aside), same exported poses."""
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "poses":
            assert len(a[k]) == len(b[k])
            for pa, pb in zip(a[k], b[k]):
                assert (pa["scene_id"], pa["im_id"], pa["score"]) == \
                    (pb["scene_id"], pb["im_id"], pb["score"])
                np.testing.assert_allclose(pb["R"], pa["R"], atol=1e-5)
                np.testing.assert_allclose(pb["t"], pa["t"], rtol=1e-5, atol=1e-4)
        elif isinstance(a[k], dict):
            assert sorted(a[k]) == sorted(b[k]), k
            for m in a[k]:
                np.testing.assert_allclose(b[k][m], a[k][m], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k}.{m}")
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6, err_msg=k)
