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
    random biases and BN means, BN scale uniform in `bn_scale` (lower it to
    keep a deep net's activations O(1)), BN var uniform in [0.5, 1.5]."""
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
