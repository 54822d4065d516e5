"""The port's overfit recipe (checkerpose_tpu_torch/tools/diag_overfit.py)
against the JAX package's, small on the CPU: hrnet_w18_small, 32 keypoints,
K=8, res_log2 3, crop_size_gt 64, 8 fixed crops of a fixture the JAX
generator writes, f32, Adam 2e-4, the auxiliary heatmap loss at 1.0, no
augmentation (both steps see the same batch).

Both packages train T steps from the same Flax initialisation
(models/convert.py::flax_to_torch). Near-ties in EdgeConv's max over K make
two training runs drift apart however small their first difference, so the
tolerance is measured: the band is the JAX run against itself with its
initial weights perturbed by 1e-6 relative, its largest separation over the
logged steps (the loss on its own, the bit errors together), and the port
stays within twice the band plus 1e-3 at every logged step. Both runs must
learn, or the comparison holds nothing. Then the port's trained weights go
back to Flax (torch_to_flax) and both packages' `evaluate_init` score them
on the same batches, where the logits are confident."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu.eval import harness as jharness
from checkerpose_tpu.models import InitNet as FlaxInitNet
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu.train.state import make_optimizer as jax_make_optimizer
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, _stack
from checkerpose_tpu_torch.data.fps import load_keypoints_normed
from checkerpose_tpu_torch.eval import harness as pharness
from checkerpose_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.ops.knn import knn_index
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.state import create_init_state, make_optimizer
from torch_parity import few_torch_threads  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, KNN, NB, CROP_GT, RES_LOG2 = 32, 8, 8, 64, 3
LR, AUX = 2e-4, 1.0
T, EVERY = 60, 10                   # steps, and the eval every EVERY steps (and at step 1)
PERTURB = 1e-6                      # relative perturbation of the band's second JAX run
CFG = dict(npoint=NPT, res_log2=RES_LOG2, backbone_name="hrnet_w18_small")
# eval parity: bits may differ only where JAX's logit is this close to 0, and
# at most this share of them
LOGIT_TIE, BIT_SHARE = 1e-3, 0.005


def _logged(i):
    return i == 1 or i % EVERY == 0


def _jax_run(fnet, knn, variables, batch, params, opt, step, ev):
    """T steps of the package's jitted pretrain `step` from `params`:
    [[loss, bit_err...] per logged step]. The step donates its state, so it
    gets fresh arrays."""
    sd = {"params": jax.tree.map(jnp.array, params),
          "batch_stats": jax.tree.map(jnp.array, variables["batch_stats"]),
          "opt_state": opt.init(params)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    curve = []
    for i in range(1, T + 1):
        key, k = jax.random.split(key)
        sd, metrics = step(sd, jb, k)
        if _logged(i):
            be = np.asarray(ev({"params": sd["params"], "batch_stats": sd["batch_stats"]},
                               jb)["bit_err"]).mean(0)
            curve.append([float(metrics["loss"]), *be])
    return np.array(curve)


def _port_run(variables, knn, batch):
    """The same T steps with the port's pretrain step, from the converted
    variables: (curve as in `_jax_run`, the trained net in eval mode)."""
    net = InitNet(**CFG, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(variables), strict=True)
    state = create_init_state(net, make_optimizer(LR), seed=None, device="cpu")
    knn_t = torch.from_numpy(knn)
    step = steps.make_pretrain_step(net, knn_t, CROP_GT, color_aug_prob=0.0,
                                    aux_heatmap_weight=AUX)
    ev = steps.make_init_eval_step(net, knn_t, CROP_GT)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    curve = []
    for i in range(1, T + 1):
        metrics = step(state, tb, gen)
        if _logged(i):
            net.eval()
            be = ev(tb)["bit_err"].mean(0).numpy()
            net.train()
            curve.append([float(metrics["loss"]), *be])
    return np.array(curve), net.eval()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    jax_make_synthetic_bop(root, n_objects=1, n_scenes=1, folders={"train_real": NB},
                           n_vertices=256, seed=7)
    xyz, normed = load_keypoints_normed(root, "synth", 1, NPT)
    knn = knn_index(normed, KNN)
    samples = scan_bop_object(root, "synth", "train_real", 1, 0.2)[:NB]
    assert len(samples) == NB
    ds = CropDataset(samples, xyz, is_train=False, crop_size_gt=CROP_GT, seed=0,
                     use_native=False)
    batch = _stack([ds[i] for i in range(NB)])
    fnet = FlaxInitNet(**CFG, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(fnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), knn, train=False))
    opt = jax_make_optimizer(LR)
    jax_steps = (opt, jsteps.make_pretrain_step(fnet, knn, opt, crop_size_gt=CROP_GT,
                                                color_aug_prob=0.0, aux_heatmap_weight=AUX),
                 jsteps.make_init_eval_step(fnet, knn, crop_size_gt=CROP_GT))
    ref = _jax_run(fnet, knn, variables, batch, variables["params"], *jax_steps)
    rng = np.random.default_rng(1)
    perturbed = jax.tree.map(
        lambda p: (p * (1 + PERTURB * rng.standard_normal(p.shape))).astype(np.float32),
        variables["params"])
    # the band's second JAX run and the port's run at once: JAX runs its
    # compiled step outside the interpreter lock, so the two share the cores
    with ThreadPoolExecutor(1) as pool:
        other = pool.submit(_jax_run, fnet, knn, variables, batch, perturbed, *jax_steps)
        port, net = _port_run(variables, knn, batch)
        other = other.result()
    steps_logged = [i for i in range(1, T + 1) if _logged(i)]
    np.set_printoptions(precision=4, suppress=True, linewidth=150)
    print(f"logged steps {steps_logged}; columns: loss, bit_err roi, x bits, y bits")
    print(f"JAX\n{ref}\nJAX perturbed - JAX\n{other - ref}\nport - JAX\n{port - ref}")
    return dict(fnet=fnet, knn=knn, batch=batch, ref=ref, other=other, port=port, net=net)


def test_pretrain_curve_within_jax_band(trained):
    """Over T >= 60 steps: both runs learn (final RoI bit error <= 0.05,
    final loss <= 0.5x the first), and at every logged step the port's
    distance from JAX stays within 2x JAX's self-perturbation band + 1e-3,
    for the loss and for each bit error."""
    ref, other, port = trained["ref"], trained["other"], trained["port"]
    assert T >= 60 and len(ref) == len(port) == 1 + T // EVERY
    for name, curve in (("JAX", ref), ("port", port)):
        assert curve[-1, 1] <= 0.05, (name, curve[-1])
        assert curve[-1, 0] <= 0.5 * curve[0, 0], (name, curve[:, 0])
    band = np.abs(other - ref)
    band_loss, band_bits = band[:, 0].max(), band[:, 1:].max()
    dist = np.abs(port - ref)
    print(f"band: loss {band_loss:.5f}, bits {band_bits:.5f}; port - JAX: loss "
          f"{dist[:, 0].max():.5f}, bits {dist[:, 1:].max():.5f}")
    assert (dist[:, 0] <= 2 * band_loss + 1e-3).all(), (dist[:, 0], band_loss)
    assert (dist[:, 1:] <= 2 * band_bits + 1e-3).all(), (dist[:, 1:], band_bits)


def test_evaluate_init_on_trained_weights_matches_jax(trained):
    """The port's trained weights carried to Flax: the two forwards' bits
    agree except at most 0.5% of them, each where JAX's logit lies within
    1e-3 of 0, and the two `evaluate_init` reports agree entry by entry
    (to what those bits can move)."""
    s = trained
    variables = jax.tree.map(jnp.asarray, torch_to_flax(s["net"].state_dict()))
    imgs = steps.device_augment_normalize(torch.from_numpy(s["batch"]["image"]), None, False,
                                          False, train=False)
    with torch.no_grad():
        got = s["net"](imgs.permute(0, 3, 1, 2), torch.from_numpy(s["knn"]))[0].numpy()
    want = np.asarray(s["fnet"].apply(variables, jnp.asarray(imgs.numpy()), s["knn"],
                                      train=False)[0])
    flips = (got > 0) != (want > 0)
    largest = float(np.abs(want).max())
    print(f"largest |logit| {largest:.3f}; bits differing {int(flips.sum())} of {flips.size}; "
          f"max |logit diff| {float(np.abs(got - want).max()):.2e}")
    assert largest >= 3.0                           # the bits are confident
    assert flips.mean() <= BIT_SHARE and (np.abs(want[flips]) <= LOGIT_TIE).all()
    halves = [{k: v[:NB // 2] for k, v in s["batch"].items()},
              {k: v[NB // 2:] for k, v in s["batch"].items()}]
    in_roi = int(np.asarray(steps.device_labels(
        {k: torch.from_numpy(v) for k, v in s["batch"].items()}, CROP_GT)[0]).sum((1, 2)).min())
    tol = 1e-6 + flips.sum() / (NB * max(in_roi, 1))
    for metric in (None, "mean_bit_acc"):
        ref = jharness.evaluate_init(s["fnet"], s["knn"], variables, [dict(b) for b in halves],
                                     CROP_GT, metric)
        rep = pharness.evaluate_init(s["net"], s["knn"], halves, CROP_GT, metric)
        assert sorted(ref) == sorted(rep)
        for k in ref:
            np.testing.assert_allclose(rep[k], ref[k], rtol=0, atol=tol, err_msg=k)


def test_bf16_forward_on_trained_weights_follows_jax(trained):
    """The port's trained weights in bf16 in both packages: the port's bf16
    logits leave JAX's bf16 ones by no more than bf16 leaves f32 in JAX
    (twice the RMS and the largest difference), and their bits differ no
    more often than JAX's bf16 and f32 bits do, plus 0.5%."""
    s = trained
    variables = jax.tree.map(jnp.asarray, torch_to_flax(s["net"].state_dict()))
    imgs = steps.device_augment_normalize(torch.from_numpy(s["batch"]["image"]), None, False,
                                          False, train=False)
    logits = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32), ("16", jnp.bfloat16,
                                                                 torch.bfloat16)):
        fnet = FlaxInitNet(**CFG, dtype=jdt)
        logits[f"jax{name}"] = np.asarray(fnet.apply(variables, jnp.asarray(imgs.numpy()),
                                                     s["knn"], train=False)[0], np.float32)
        net = InitNet(**CFG, dtype=tdt)
        net.load_state_dict(s["net"].state_dict(), strict=True)
        with torch.no_grad():
            logits[f"port{name}"] = net.eval()(imgs.permute(0, 3, 1, 2),
                                               torch.from_numpy(s["knn"]))[0].float().numpy()
    d_pkg = np.abs(logits["port16"] - logits["jax16"])
    d_bf = np.abs(logits["jax16"] - logits["jax32"])
    rms = lambda d: float(np.sqrt((d ** 2).mean()))  # noqa: E731
    flips = lambda a, b: float(((logits[a] > 0) != (logits[b] > 0)).mean())  # noqa: E731
    print(f"port bf16 - JAX bf16: rms {rms(d_pkg):.2e}, max {d_pkg.max():.2e}, bits "
          f"{flips('port16', 'jax16'):.4f}; JAX bf16 - f32: rms {rms(d_bf):.2e}, max "
          f"{d_bf.max():.2e}, bits {flips('jax16', 'jax32'):.4f}")
    assert rms(d_pkg) <= 2 * rms(d_bf) and d_pkg.max() <= 2 * d_bf.max()
    assert flips("port16", "jax16") <= flips("jax16", "jax32") + 0.005
