"""Port ops/augment.py vs checkerpose_tpu/ops/augment.py with fixed
parameters: the test re-derives from the PRNG key what each JAX op drew
(the same `jax.random` calls on the same sub-keys), hands those parameters
to the port's apply half, and compares the images: 1e-3 on a [0, 255] scale
(f32 blurs and products). The draw halves are checked for shapes, ranges
and rates only: the random streams of JAX and torch differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.ops import augment as jaug
from checkerpose_tpu_torch.ops import augment

B, H, W = 3, 64, 48
TOL = dict(rtol=0, atol=1e-3)


def _images(seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (B, H, W, 3)).astype(np.float32)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _channel_values(key, lo, hi, per_channel_p):
    k1, k2, k3 = jax.random.split(key, 3)
    per_ch = jax.random.uniform(k1) < per_channel_p
    v_ch = jax.random.uniform(k2, (3,), minval=lo, maxval=hi)
    v_one = jax.random.uniform(k3, (), minval=lo, maxval=hi)
    return jnp.where(per_ch, v_ch, jnp.broadcast_to(v_one, (3,)))


def _drawn(name, key):
    """What `jaug.<name>(key, img)` draws, as the port's apply half takes it."""
    if name == "salt_and_pepper":
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, (H, W)) < 0.05, jax.random.uniform(k2, (H, W)) < 0.5)
    if name == "motion_blur":
        return (jax.random.randint(key, (), 0, 4),)
    if name == "coarse_dropout":
        return (jax.random.uniform(key, augment.coarse_dropout_grid(H, W)) >= 0.1,)
    if name == "gaussian_blur":
        return (jax.random.uniform(key, (), minval=0.0, maxval=1.0),)
    if name == "add_value":
        return (_channel_values(key, -20.0, 20.0, 0.3),)
    if name == "invert":
        return (jax.random.uniform(key, (3,)) < 0.2,)
    if name == "multiply":
        return (_channel_values(key, 0.7, 1.4, 0.0),)
    if name == "multiply_ch":
        return (_channel_values(key, 0.7, 1.4, 0.8),)
    if name == "contrast_normalization":
        return (_channel_values(key, 0.5, 2.0, 0.3),)
    raise KeyError(name)


def _stack(per_sample):
    """[(p0, p1, ...) per sample] -> (P0 (B, ...), P1 (B, ...), ...) torch."""
    return tuple(torch.from_numpy(np.stack([np.asarray(s[i]) for s in per_sample]))
                 for i in range(len(per_sample[0])))


OPS = ["salt_and_pepper", "motion_blur", "coarse_dropout", "gaussian_blur", "add_value",
       "invert", "multiply", "contrast_normalization"]


@pytest.mark.parametrize("name", OPS)
def test_op_with_fixed_parameters_matches_jax(name):
    img = _images(OPS.index(name))
    keys = _keys(10 + OPS.index(name))
    ref = np.stack([np.asarray(getattr(jaug, name)(k, jnp.asarray(x)))
                    for k, x in zip(keys, img)])
    params = _stack([_drawn(name, k) for k in keys])
    out = getattr(augment, name)(torch.from_numpy(img), *params)
    assert out.shape == (B, H, W, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.abs(ref - img).max() > 0          # the op did something


def test_coarse_dropout_resizes_by_cell_centres():
    """A (3, 2) keep-mask on (64, 48): row i reads floor((i + 0.5) * 3 / 64),
    which differs from floor(i * 3 / 64) at rows 21 and 42 -> 43."""
    keep = torch.tensor([[[True, False], [False, True], [True, True]]])
    out = augment.coarse_dropout(torch.ones(1, H, W, 3), keep)[0, :, :, 0]
    rows = ((np.arange(H) + 0.5) * 3 / H).astype(int)
    cols = ((np.arange(W) + 0.5) * 2 / W).astype(int)
    np.testing.assert_array_equal(out.numpy(), keep[0].numpy()[rows][:, cols].astype(np.float32))
    ref = jax.image.resize(jnp.asarray(keep[0].numpy(), jnp.float32), (H, W), "nearest")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("use_pepper_salt,use_motion_blur", [(True, True), (False, False)])
def test_chain_with_fixed_parameters_matches_jax(use_pepper_salt, use_motion_blur):
    """`color_augment`'s order, gates, clip and outer gate: the gates and
    parameters JAX drew for each sample go through `apply_color_augment`."""
    img = _images(20)
    keys = _keys(21)
    ref = np.stack([np.asarray(jaug.color_augment(k, jnp.asarray(x), use_pepper_salt,
                                                   use_motion_blur, apply_prob=0.8))
                    for k, x in zip(keys, img)])
    chain = [("salt_and_pepper", 0.3, 1), ("motion_blur", 0.2, 2), ("coarse_dropout", 0.4, 3),
             ("gaussian_blur", 0.5, 4), ("add_value", 0.5, 5), ("invert", 0.4, 6),
             ("multiply_ch", 0.5, 7), ("multiply", 0.5, 8), ("contrast_normalization", 0.5, 9)]
    off = {"salt_and_pepper": not use_pepper_salt, "motion_blur": not use_motion_blur}
    per_sample = {name: [] for name, _, _ in chain}
    apply = []
    for key in keys:
        ks = jax.random.split(key, 10)
        apply.append(np.asarray(jax.random.uniform(ks[0]) < 0.8))
        for name, p, i in chain:
            k1, k2 = jax.random.split(ks[i])
            per_sample[name].append((jax.random.uniform(k1) < p, *_drawn(name, k2)))
    params = {"apply": torch.from_numpy(np.stack(apply))}
    for name, _, _ in chain:
        params[name] = None if off.get(name) else _stack(per_sample[name])
    out = augment.apply_color_augment(torch.from_numpy(img), params)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0


def test_draws_have_the_documented_shapes_ranges_and_rates():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    p = augment.draw_color_augment(gen, n, 8, 8)
    assert set(p) == {"apply", "salt_and_pepper", "motion_blur", "coarse_dropout",
                      "gaussian_blur", "add_value", "invert", "multiply_ch", "multiply",
                      "contrast_normalization"}
    rates = {"apply": 0.8, "salt_and_pepper": 0.3, "motion_blur": 0.2, "coarse_dropout": 0.4,
             "gaussian_blur": 0.5, "add_value": 0.5, "invert": 0.4, "multiply_ch": 0.5,
             "multiply": 0.5, "contrast_normalization": 0.5}
    for name, rate in rates.items():
        gate = p[name] if name == "apply" else p[name][0]
        assert gate.shape == (n,) and gate.dtype == torch.bool
        assert abs(float(gate.float().mean()) - rate) < 0.04, name
    hit, salt = p["salt_and_pepper"][1:]
    assert hit.shape == salt.shape == (n, 8, 8)
    assert abs(float(hit.float().mean()) - 0.05) < 0.01
    idx, = p["motion_blur"][1:]
    assert idx.dtype == torch.int64 and int(idx.min()) == 0 and int(idx.max()) == 3
    keep, = p["coarse_dropout"][1:]
    assert keep.shape == (n, 1, 1) and abs(float(keep.float().mean()) - 0.9) < 0.03
    sigma, = p["gaussian_blur"][1:]
    assert 0.0 <= float(sigma.min()) and float(sigma.max()) < 1.0
    for name, lo, hi, per_ch in (("add_value", -20.0, 20.0, 0.3), ("multiply_ch", 0.7, 1.4, 0.8),
                                 ("multiply", 0.7, 1.4, 0.0),
                                 ("contrast_normalization", 0.5, 2.0, 0.3)):
        v, = p[name][1:]
        assert v.shape == (n, 3) and lo <= float(v.min()) and float(v.max()) < hi
        differs = (v[:, 0] != v[:, 1]).float().mean()
        assert abs(float(differs) - per_ch) < 0.04, name
    off = augment.draw_color_augment(gen, 4, 8, 8, use_pepper_salt=False, use_motion_blur=False)
    assert off["salt_and_pepper"] is None and off["motion_blur"] is None


def test_color_augment_is_reproducible_and_gated():
    img = torch.from_numpy(_images(30))
    a = augment.color_augment(torch.Generator().manual_seed(5), img)
    b = augment.color_augment(torch.Generator().manual_seed(5), img)
    assert torch.equal(a, b) and not torch.equal(a, img)
    assert torch.equal(augment.color_augment(torch.Generator().manual_seed(5), img,
                                             apply_prob=0.0), img)
