"""Port ops/codes.py and ops/geometry.py::make_code_labels vs the JAX
package: integer results, compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.ops import codes as jcodes
from checkerpose_tpu.ops import geometry as jgeometry
from checkerpose_tpu_torch.ops import codes, geometry


@pytest.mark.parametrize("num_bits", [3, 6, 7])
def test_ids_codes_round_trip_and_parity(num_bits):
    rng = np.random.default_rng(num_bits)
    ids = rng.integers(0, 2 ** num_bits, (4, 9)).astype(np.int32)
    c = codes.ids_to_codes(torch.from_numpy(ids), num_bits)
    assert c.dtype == torch.int32 and c.shape == (4, 9, num_bits)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jcodes.ids_to_codes(jnp.asarray(ids),
                                                                             num_bits)))
    back = codes.codes_to_ids(c)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), ids)
    np.testing.assert_array_equal(codes.codes_to_ids(c.float()).numpy(), ids)


def test_logits_to_ids_and_mask_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 8, 6)).astype(np.float32)
    logits[0, 0, :] = 0.0                      # sigmoid(0) = 0.5 is not > 0.5
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(codes.probs_to_bits(t).numpy(),
                                  np.asarray(jcodes.probs_to_bits(jnp.asarray(logits))))
    np.testing.assert_array_equal(codes.logits_to_ids(t).numpy(),
                                  np.asarray(jcodes.logits_to_ids(jnp.asarray(logits))))
    m = codes.logits_to_mask(t)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jcodes.logits_to_mask(jnp.asarray(logits))))
    assert codes.logits_to_ids(t)[0, 0] == 0


def _label_inputs():
    rng = np.random.default_rng(2)
    B, N, S = 5, 40, 64
    bbox = np.array([[50, 60, 128, 128], [10.5, 20.25, 97.3, 97.3], [0, 0, 64, 64],
                     [30, 30, 0, 0], [5, 5, 100, -3]], np.float32)
    proj = rng.uniform(-20, 260, (B, N, 2)).astype(np.float32)
    # points exactly on cell edges, on the bbox origin, on its far edge (id == S:
    # out of roi) and just before the origin (trunc(-0.4) = 0, but out of roi)
    cell = bbox[0, 2] / S
    proj[0, :6, 0] = bbox[0, 0] + np.array([0, 1, 2, S - 1, S, -0.4], np.float32) * cell
    proj[0, :6, 1] = bbox[0, 1] + np.array([0, 1, S - 1, 2, 3, 1], np.float32) * cell
    proj[2, :4] = np.array([[0, 0], [63, 63], [64, 10], [63.999, 0.001]], np.float32)
    return proj, bbox, S


def test_make_code_labels_matches_jax():
    proj, bbox, S = _label_inputs()
    f = jax.vmap(lambda p, b: jgeometry.make_code_labels(p, b, S))
    ref = [np.asarray(a) for a in f(jnp.asarray(proj), jnp.asarray(bbox))]
    roi, x_id, y_id = geometry.make_code_labels(torch.from_numpy(proj), torch.from_numpy(bbox), S)
    assert roi.dtype == torch.float32 and x_id.dtype == y_id.dtype == torch.int32
    for got, want in zip((roi, x_id, y_id), ref):
        np.testing.assert_array_equal(got.numpy(), want)
    # the edge cases did land where they were put
    assert roi[0, :6].tolist() == [1, 1, 1, 1, 0, 0]
    assert x_id[0, :6].tolist() == [0, 1, 2, S - 1, S - 1, 0]


def test_make_code_labels_degenerate_bbox_is_nan_free():
    proj, bbox, S = _label_inputs()
    roi, x_id, y_id = geometry.make_code_labels(torch.from_numpy(proj), torch.from_numpy(bbox), S)
    for b in (3, 4):                           # w = h = 0, and h < 0
        assert roi[b].sum() == 0
    assert int(x_id[3].max()) <= S - 1 and int(x_id[3].min()) >= 0
    # every projection on the origin of a zero-size box: id 0, roi 0
    origin = torch.tensor([[[30.0, 30.0]]]).expand(1, 4, 2)
    r, x, y = geometry.make_code_labels(origin, torch.tensor([[30.0, 30.0, 0.0, 0.0]]), S)
    assert r.sum() == 0 and x.abs().sum() == 0 and y.abs().sum() == 0
