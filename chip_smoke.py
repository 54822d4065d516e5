#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table
    python3 chip_smoke.py --steps         # also time the tensor-core kernel beside
                                          # a build of it with synchronous copies

Phases (each raises on failure; the script then exits non-zero):
  1. build    nvcc-compile every CUDA kernel of the port from csrc/ (in
              parallel) and print ptxas's register and spill report and
              each EdgeConv kernel's dynamic shared memory;
  2. kernels  hold both EdgeConv kernels against the plain PyTorch version on
              the card at the main path's shapes (the tensor-core kernel in
              bf16; the FMA kernel in f32 and, forced, in bf16) and at one
              ragged shape each, and time them with CUDA events beside the
              function's bound;
  3. serving  ServingPipeline at bench.py's configuration (hrnet_w18, 512
              keypoints, K=20, stage 3, batch 512 of 256x256 uint8 crops,
              FAST_PROFILE): crops/s, peak memory, EdgeConv launches (must be
              11 per forward, all on the tensor-core route), finite R and t;
  4. reference the network on the card vs on the CPU, f32, same weights, a
              few crops: ids agree on > 95% of keypoints, seg within 2e-2;
              the f32 forward must go through the FMA kernel 11 times;
  5. oracle   exact codes from known poses through the port's decode and
              solver at batch 512: every pose within 3 deg and 10 units;
  6. train    the training path at the flagship width (hrnet_w18, 512
              keypoints, K=20, stage 3, batch 32, bf16 compute, Adam 1e-4) on
              synthetic batches: (1) train and pretrain steps give finite
              metrics and a falling loss; (2) card against CPU, f32, batch 2:
              loss, gradients (against an f64 run too) and running statistics; (3) after the
              steps, the eval forward refolds every EdgeConv once and goes
              through the tensor-core kernel 11 times; (4) run_training with
              rolling, best and restored checkpoints; then ms per step,
              steps/s and peak memory with the configured augmentation on,
              with --profile the shares of the step by layer type.
Then one JSON line with the kernels, the card's name and power limit, and
the last line {"ok": true, "device": {...}}.

Weights are random (Flax initialisers, seeded by --seed). The phase
functions take the device and sizes, so a CPU test can rehearse them small;
run as a script, the CPU is refused.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_F32_S = 67e12

# bench.py's network: 3 refine stages (8 -> 64), 3 EdgeConvs each, 2 in the init net
POSENET_CFG = dict(res_log2=6, num_graph_module=3, init_num_graph_module=2, local_k=2)
EDGECONV_PER_FORWARD = 11           # 2 in the init net + 3 x 3 refine stages
MAIN_WIDTHS = {64: 2, 256: 9}       # C=C' -> launches per forward


CARD = ""                           # name and power limit, set by main() on the card


def say(msg: str):
    """Print a result line with the card it was measured on."""
    print(f"{msg} [{CARD}]" if CARD else msg)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int, warm: int = 2):
    """Mean ms per call from CUDA events around `iters` calls after `warm`
    calls; None off the card (a CPU run measures no device time)."""
    if device.type != "cuda":
        fn()
        return None
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def phase_build():
    from checkerpose_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    say(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line:     # registers, barriers; stack and spills
                say(f"[build] {name}: {line.strip()}")
    from checkerpose_tpu_torch.ops.edgeconv import _lib
    say(f"[build] dynamic shared memory per block at N=512, K=20: fma route "
          f"{_lib('fma').edgeconv_fused_smem_bytes(512, 20)} B; tc route at C=64 "
          f"{_lib('tc').edgeconv_tc_smem_bytes(512, 64)} B "
          f"({_lib('tc').edgeconv_tc_stages(512, 64)} ring stages), at C=256 "
          f"{_lib('tc').edgeconv_tc_smem_bytes(512, 256)} B "
          f"({_lib('tc').edgeconv_tc_stages(512, 256)} ring stages)")


def edgeconv_bound_ms(B, N, K, C, Cp, dtype):
    """Least time for one launch: the larger of bytes over HBM rate and
    operations over the peak rate for their type. Bytes: x, w1, w2m1, knn,
    scale, bias read once, out written once. Operations: the two per-node
    projections (2*2*B*N*C*Cp, tensor cores for bf16, f32 FMA for f32) and
    one compare per edge and channel (B*N*K*Cp at the f32 rate), which run
    on different units, so the larger of the two counts."""
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (B * N * C + 2 * C * Cp + B * N * Cp) + 4 * N * K + 8 * Cp
    proj_s = 4.0 * B * N * C * Cp / (PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S)
    edge_s = 1.0 * B * N * K * Cp / PEAK_F32_S
    bytes_ms, ops_ms = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * max(proj_s, edge_s)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _edgeconv_inputs(B, N, K, C, Cp, device, seed):
    from checkerpose_tpu_torch.ops.knn import knn_index
    g = torch.Generator().manual_seed(seed)
    knn = torch.as_tensor(knn_index(torch.randn(N, 3, generator=g).numpy(), K), device=device)
    x = torch.randn(B, N, C, generator=g).to(device)
    W = torch.randn(2 * C, Cp, generator=g) / math.sqrt(2 * C)
    gamma = 0.5 + torch.rand(Cp, generator=g)
    gamma[::7] *= -1.0                       # exercise the s < 0 (min) branch
    beta = 0.1 * torch.randn(Cp, generator=g)
    mean = 0.1 * torch.randn(Cp, generator=g)
    var = 0.5 + torch.rand(Cp, generator=g)
    scale = gamma / torch.sqrt(var + 1e-5)
    bias = beta - mean * scale
    return (x, knn, W[:C].to(device), (W[C:] - W[:C]).to(device),
            scale.to(device), bias.to(device))


RAGGED_SHAPE = (3, 100, 7, 48, 40)    # B, N, K, C, C': partial node, k and channel tiles
KERNEL_CASES = (("tc", torch.bfloat16), ("fma", torch.float32), ("fma", torch.bfloat16))


def phase_kernels(device, B=512, N=512, K=20, widths=(64, 256), iters=20,
                  plain_iters=3, seed=0):
    """Both kernels vs the plain version: `edgeconv_fused` in bf16 (the
    tensor-core kernel) and in f32 (the FMA kernel), and the FMA kernel
    forced in bf16 (for the two kernels' times side by side), at each
    main-path width and, untimed, at one ragged shape.
    Tolerances: f32 rtol = atol = 2e-3 (the Pallas kernel's parity bar);
    bf16 against the plain version run in f32 on the same bf16-rounded
    inputs, |out - ref| <= 1e-3 + 2**-8 |ref| (the output's bf16 rounding is
    at most 2**-9 |ref|; the rest covers summation order)."""
    from checkerpose_tpu_torch.ops.edgeconv import (
        _launch, edgeconv_fused, edgeconv_fused_plain, pack_edgeconv_weights)
    rows = []
    shapes = [((B, N, K, C, C), False) for C in widths] + [(RAGGED_SHAPE, True)]
    for (b_, n_, k_, c_, cp_), ragged in shapes:
        x32, knn, w1, w2m1, scale, bias = _edgeconv_inputs(b_, n_, k_, c_, cp_, device, seed)
        plain_ms = {}
        for kernel, dtype in KERNEL_CASES:
            x, a, b = x32.to(dtype), w1.to(dtype), w2m1.to(dtype)
            packed = pack_edgeconv_weights(a, b) if kernel == "tc" else None

            # through the wrapper the model calls, whose route rule must pick
            # `kernel`; only the FMA kernel in bf16 has to be asked for by name
            forced = (kernel, dtype) == ("fma", torch.bfloat16) and device.type == "cuda"

            def run():
                if forced:
                    return _launch(kernel, x, knn, a, b, scale, bias)
                return edgeconv_fused(x, knn, a, b, scale, bias, packed=packed)

            before = dict(edgeconv_fused.launches_by_route)
            out = run()
            _sync(device)
            took = {r: edgeconv_fused.launches_by_route[r] - before[r] for r in before}
            want = {r: int(r == kernel and device.type == "cuda") for r in before}
            if took != want:
                raise AssertionError(f"route {kernel} asked, launches counted {took}")
            ref = edgeconv_fused_plain(x.float(), knn, a.float(), b.float(), scale, bias)
            err = (out.float() - ref).abs()
            if dtype == torch.float32:
                ok = torch.allclose(out, ref, rtol=2e-3, atol=2e-3)
                tol = "rtol=atol=2e-3"
            else:
                ok = bool((err <= 1e-3 + 2 ** -8 * ref.abs()).all())
                tol = "1e-3 + 2^-8|ref|"
            max_err = float(err.max())
            del ref, err
            name = str(dtype).replace("torch.", "")
            what = (f"edgeconv_fused[{kernel}] B={b_} N={n_} K={k_} C={c_} C'={cp_} {name}"
                    f"{' (ragged)' if ragged else ''}")
            if not ok:
                raise AssertionError(f"{what} disagrees with its plain version: "
                                     f"max |err| {max_err} (tol {tol})")
            ms = None
            if not ragged:
                ms = time_ms(run, device, iters)
                if dtype not in plain_ms:
                    plain_ms[dtype] = time_ms(
                        lambda: edgeconv_fused_plain(x, knn, a, b, scale, bias),
                        device, plain_iters, warm=1)
            bound_ms, bound_by = edgeconv_bound_ms(b_, n_, k_, c_, cp_, dtype)
            rows.append({"kernel": kernel, "B": b_, "N": n_, "K": k_, "C": c_, "Cp": cp_,
                         "dtype": name, "ragged": ragged, "max_abs_err": max_err, "tol": tol,
                         "ms": ms, "plain_ms": plain_ms.get(dtype), "bound_ms": bound_ms,
                         "bound_by": bound_by})
            say(f"[kernels] {what}: max|err| {max_err:.3g} ({tol}) ok; kernel {ms} ms, "
                  f"plain {plain_ms.get(dtype)} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def _sync_copies_lib():
    """csrc/edgeconv_tc.cu built with -DEDGECONV_TC_SYNC_COPIES (a ring of
    one stage) beside the library the port loads; a measurement build."""
    import ctypes
    from checkerpose_tpu_torch.ops import _build
    from checkerpose_tpu_torch.ops.edgeconv import _typed
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libedgeconv_tc-sync_copies.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DEDGECONV_TC_SYNC_COPIES",
                    "-o", str(lib), str(_build.SOURCES["edgeconv_tc"])],
                   check=True, capture_output=True, text=True, timeout=600)
    return _typed(ctypes.CDLL(str(lib)), "tc")


def phase_steps(device, B=512, N=512, K=20, widths=(64, 256), iters=20, seed=0):
    """What the asynchronous copies buy: the tensor-core kernel as the port
    loads it beside the same source built with a ring of one stage, timed in
    turns on the same inputs; the two must give the same bits."""
    from checkerpose_tpu_torch.ops.edgeconv import _lib, pack_edgeconv_weights
    libs = {"full": _lib("tc"), "sync_copies": _sync_copies_lib()}
    res = []
    for C in widths:
        x32, knn, w1, w2m1, scale, bias = _edgeconv_inputs(B, N, K, C, C, device, seed)
        x = x32.bfloat16()
        packed = pack_edgeconv_weights(w1.bfloat16(), w2m1.bfloat16())
        outs = {k: torch.empty_like(x) for k in libs}
        stream = torch.cuda.current_stream(device).cuda_stream

        def launch(k):
            err = libs[k].edgeconv_tc_launch(
                x.data_ptr(), knn.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), outs[k].data_ptr(), B, N, C, C, K, 0.2, stream)
            if err != 0:
                raise RuntimeError(f"edgeconv_tc ({k}) launch failed: CUDA error {err}")

        ms = {k: [] for k in libs}
        for k in [*libs, *reversed(libs)]:
            ms[k].append(time_ms(lambda: launch(k), device, iters))
        if not torch.equal(outs["full"], outs["sync_copies"]):
            raise AssertionError(f"the one-stage build and the ring differ at C={C}")
        res.append({"C": C, **{f"{k}_ms": v for k, v in ms.items()}})
        say(f"[steps] edgeconv_fused[tc] B={B} N={N} K={K} C=C'={C} bf16, two turns each: "
            + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in ms.items()))
    return res


def phase_serving(device, batch=512, npoint=512, backbone="hrnet_w18", warm=2, iters=5,
                  seed=0, profile_dir=None):
    """ServingPipeline at bench.py's configuration; returns its numbers."""
    from checkerpose_tpu_torch.models.posenet import make_posenet
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
    from checkerpose_tpu_torch.ops.geometry import pc_normalize
    from checkerpose_tpu_torch.ops.knn import knn_index
    from checkerpose_tpu_torch.serving import ServingPipeline
    from checkerpose_tpu_torch.solver.ransac import ransac_pnp

    rng = np.random.default_rng(seed)
    p3d = rng.uniform(-40, 40, (npoint, 3)).astype(np.float32)
    p3dn = pc_normalize(p3d).astype(np.float32)
    knn = knn_index(p3dn, 20)
    net = make_posenet(device=device, seed=seed, npoint=npoint, backbone_name=backbone,
                       **POSENET_CFG)
    pipe = ServingPipeline(net, knn, p3d, p3dn, device=device)
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 255, (batch, 256, 256, 3), generator=g,
                           dtype=torch.uint8).to(device)
    bbox = torch.tensor([[50., 60., 130., 130.]], device=device).expand(batch, 4)
    K = torch.tensor([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    for _ in range(warm):
        pipe(images, bbox, K, gen)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = pipe(images, bbox, K, gen)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = edgeconv_fused.launches
    by_route = dict(edgeconv_fused.launches_by_route)

    expected = EDGECONV_PER_FORWARD * iters if device.type == "cuda" else 0
    if launches != expected or by_route != {"tc": expected, "fma": 0}:
        raise AssertionError(f"EdgeConv kernel launches {launches} {by_route}, expected "
                             f"{expected}, all on the tensor-core route")
    if tuple(out["R"].shape) != (batch, 3, 3) or tuple(out["t"].shape) != (batch, 3):
        raise AssertionError(f"bad output shapes {out['R'].shape} {out['t'].shape}")
    if not (torch.isfinite(out["R"]).all() and torch.isfinite(out["t"]).all()):
        raise AssertionError("non-finite R or t")

    # split of one batch: network forward + decode, then the solver
    with torch.inference_mode():
        t1 = time.perf_counter()
        p2d, valid = pipe.correspondences(images, bbox)
        _sync(device)
        t2 = time.perf_counter()
        ransac_pnp(pipe.p3d.expand(batch, npoint, 3), p2d, valid, K.expand(batch, 3, 3),
                   gen, **pipe.solver_kw)
        _sync(device)
        t3 = time.perf_counter()

    on_card = device.type == "cuda"
    res = {"batch": batch, "iters": iters, "edgeconv_launches": launches,
           "edgeconv_launches_by_route": by_route,
           "crops_per_s": batch * iters / dt if on_card else None,
           "batch_ms": 1e3 * dt / iters if on_card else None,
           "forward_decode_ms": 1e3 * (t2 - t1) if on_card else None,
           "solver_ms": 1e3 * (t3 - t2) if on_card else None,
           "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None,
           "success_rate": float(out["success"].float().mean())}
    res["kernel_launches_per_batch"], res["device_ms_per_batch"] = count_kernel_launches(
        lambda: pipe(images, bbox, K, gen), device)
    say(f"[serving] {backbone} npoint={npoint} K=20 stage=3 batch={batch} FAST_PROFILE: "
          f"{res['crops_per_s']} crops/s ({res['batch_ms']} ms/batch over {iters}); "
          f"forward+decode {res['forward_decode_ms']} ms, solver {res['solver_ms']} ms; "
          f"peak {res['peak_mem_gib']} GiB; EdgeConv launches {launches} "
          f"= {EDGECONV_PER_FORWARD} x {iters} forwards, by route {by_route}; R, t finite; "
          f"{res['kernel_launches_per_batch']} kernel launches and "
          f"{res['device_ms_per_batch']} ms of device time a batch (profiler)")

    if profile_dir is not None and on_card:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe(images, bbox, K, gen)
            _sync(device)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        (Path(profile_dir) / "serving_profile.txt").write_text(table)
        say("[serving] profile (top rows by device time):")
        print("\n".join(table.splitlines()[:16]))
    return res


def phase_reference(device, batch=2, npoint=512, backbone="hrnet_w18", seed=0):
    """The network on the card against the same network on the CPU, both in
    f32 from the same seeded weights, on a few crops: hard ids agree on more
    than 95% of keypoints and seg probabilities within 2e-2 (the bars of the
    JAX package's fused-forward test). The f32 forward is the FMA kernel's
    path: its launches are counted from 0 and must be 11, none on the
    tensor-core route. The card's bf16 model is compared too and its id
    agreement reported."""
    from checkerpose_tpu_torch.models.posenet import knn_tensor, make_posenet
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
    from checkerpose_tpu_torch.ops.crop import normalize_image
    from checkerpose_tpu_torch.ops.geometry import pc_normalize
    from checkerpose_tpu_torch.ops.knn import knn_index

    rng = np.random.default_rng(seed + 1)
    knn = knn_index(pc_normalize(rng.uniform(-40, 40, (npoint, 3))), 20)
    images = torch.from_numpy(rng.integers(0, 255, (batch, 256, 256, 3)).astype(np.uint8))
    cfg = dict(npoint=npoint, backbone_name=backbone, **POSENET_CFG)

    def run(dev, dtype):
        net = make_posenet(device=dev, seed=seed, dtype=dtype, **cfg)
        with torch.inference_mode():
            out = net(normalize_image(images.to(dev)), knn_tensor(knn, npoint, dev))
        return {k: v.float().cpu() for k, v in out.items()}

    ref = run(torch.device("cpu"), torch.float32)
    res = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        reset_launch_counts()
        out = run(device, dtype)
        res[name] = {k: float((out[k] == ref[k]).float().mean()) for k in ("x_id", "y_id")}
        res[name]["edgeconv_launches_by_route"] = dict(edgeconv_fused.launches_by_route)
        res[name]["seg_max_abs_err"] = float(
            (torch.sigmoid(out["seg_logits"]) - torch.sigmoid(ref["seg_logits"])).abs().max())
    f32 = res["f32"]
    fma = EDGECONV_PER_FORWARD if device.type == "cuda" else 0
    if f32["edgeconv_launches_by_route"] != {"tc": 0, "fma": fma}:
        raise AssertionError(f"the f32 forward's EdgeConv launches "
                             f"{f32['edgeconv_launches_by_route']}, expected {fma} on the "
                             f"FMA route")
    if min(f32["x_id"], f32["y_id"]) <= 0.95 or f32["seg_max_abs_err"] >= 2e-2:
        raise AssertionError(f"card f32 forward disagrees with the CPU forward: {f32}")
    say(f"[reference] {backbone} npoint={npoint} batch={batch}, card vs CPU f32 forward: "
          f"x_id/y_id agree {f32['x_id']:.4f}/{f32['y_id']:.4f}, seg max err "
          f"{f32['seg_max_abs_err']:.3g} (bars: > 0.95, < 2e-2), EdgeConv launches "
          f"{f32['edgeconv_launches_by_route']}; card bf16 vs CPU f32: "
          f"{res['bf16']['x_id']:.4f}/{res['bf16']['y_id']:.4f}, seg max err "
          f"{res['bf16']['seg_max_abs_err']:.3g}")
    return res


def _oracle_codes(uv, bbox, S):
    """Exact binary-code labels of projections (the JAX package's
    make_code_labels, batched): roi bit and ids at resolution S."""
    px = bbox[:, None, 2:4] / S
    rel = (uv - bbox[:, None, 0:2]) / px
    ids = torch.trunc(rel).to(torch.int32)
    out = (uv < bbox[:, None, 0:2]).any(-1) | (ids >= S).any(-1)
    ids = ids.clamp(0, S - 1)
    return (~out).float(), ids[..., 0], ids[..., 1]


CAM_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1.0]])


def _random_poses(rng, batch, p3d):
    """Random rotations and translations in front of CAM_K, the keypoints'
    projections uv (batch, N, 2) and a square bbox around them with a margin:
    (Q, t, uv, bbox, side)."""
    Q, _ = np.linalg.qr(rng.standard_normal((batch, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    t = np.stack([rng.uniform(-20, 20, batch), rng.uniform(-20, 20, batch),
                  rng.uniform(350, 500, batch)], -1)
    cam = p3d[None] @ Q.transpose(0, 2, 1) + t[:, None]
    proj = cam @ CAM_K.T
    uv = proj[..., :2] / proj[..., 2:3]
    side = np.maximum(np.ptp(uv[..., 0], 1), np.ptp(uv[..., 1], 1)) * 1.4
    bbox = np.stack([uv[..., 0].min(1) - side * 0.15, uv[..., 1].min(1) - side * 0.15,
                     side, side], -1)
    return Q, t, uv, bbox, side


def phase_oracle(device, batch=512, npoint=512, S=64, seed=0):
    """Known poses -> exact codes -> port decode + FAST_PROFILE solver."""
    from checkerpose_tpu_torch.eval.decode import ids_to_correspondences
    from checkerpose_tpu_torch.solver.ransac import FAST_PROFILE, solve_poses_batched

    rng = np.random.default_rng(seed)
    K = CAM_K
    p3d = rng.uniform(-40, 40, (npoint, 3))
    Q, t, uv, bbox, side = _random_poses(rng, batch, p3d)

    uv_t = torch.as_tensor(uv, dtype=torch.float32, device=device)
    bbox_t = torch.as_tensor(bbox, dtype=torch.float32, device=device)
    roi, x_id, y_id = _oracle_codes(uv_t, bbox_t, S)
    with torch.inference_mode():
        p2d, valid = ids_to_correspondences(x_id, y_id, roi, bbox_t, crop_size_gt=S)
    # exact codes at S carry up to one cell diagonal of quantization error
    # (~3 px here), more than the 2 px threshold meant for a net's outputs,
    # so the inlier threshold is the largest cell diagonal of the batch
    thresh = float(np.sqrt(2) * side.max() / S)
    gen = torch.Generator(device=device).manual_seed(seed)
    sol = solve_poses_batched(p3d.astype(np.float32), p2d, valid, K.astype(np.float32),
                              gen, device=device, reproj_thresh=thresh, **FAST_PROFILE)
    R = sol["R"].double().cpu().numpy()
    cos = (np.trace(R @ Q.transpose(0, 2, 1), axis1=1, axis2=2) - 1) / 2
    rot_err = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    t_err = np.linalg.norm(sol["t"].double().cpu().numpy() - t, axis=1)
    bad = np.flatnonzero((rot_err >= 3.0) | (t_err >= 10.0) | ~sol["success"].cpu().numpy())
    if bad.size:
        raise AssertionError(f"oracle poses off for {bad.size}/{batch} items, e.g. item "
                             f"{bad[0]}: rot {rot_err[bad[0]]:.3f} deg, t {t_err[bad[0]]:.3f}")
    say(f"[oracle] batch={batch} npoint={npoint} S={S} FAST_PROFILE, inlier threshold "
          f"{thresh:.3f} px: all poses recovered; max rot err "
          f"{rot_err.max():.4f} deg, max t err {t_err.max():.4f}")
    return {"max_rot_err_deg": float(rot_err.max()), "max_t_err": float(t_err.max())}


# the flagship single-object network of config/lmo/hr18GNN2_res6_gnn3Skip_mlpQuery.txt
# and its pretraining config init_gnn2_hrnetw18_npt512.txt
TRAIN_LR, PRETRAIN_LR, PRETRAIN_CROP_GT = 1e-4, 2e-4, 128


def _train_batches(rng, n, batch, p3d, p3dn):
    """`n` synthetic training batches as numpy dicts: uint8 crops, the 512
    keypoints of random poses projected as the oracle phase does (`proj_xy`,
    `bbox`), random 64x64 masks, and the normalized keypoints."""
    out = []
    for _ in range(n):
        _, _, uv, bbox, _ = _random_poses(rng, batch, p3d)
        out.append({
            "image": rng.integers(0, 255, (batch, 256, 256, 3), dtype=np.uint8),
            "proj_xy": uv.astype(np.float32), "bbox": bbox.astype(np.float32),
            "mask_visib": (rng.random((batch, 64, 64)) > 0.5).astype(np.float32),
            "mask_full": (rng.random((batch, 64, 64)) > 0.3).astype(np.float32),
            "p3d_normed": np.broadcast_to(p3dn[None], (batch, *p3dn.shape)).copy()})
    return out


def _on(device, batch):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _edgeconvs(net):
    from checkerpose_tpu_torch.models.graph import EdgeConv
    return [m for m in net.modules() if isinstance(m, EdgeConv)]


def _falls(losses, what):
    """Gate 1's rule: every loss finite and the mean of the last 5 below the
    mean of the first 5."""
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss in {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"{what}: loss did not fall, first 5 mean {first}, last 5 {last}")
    return first, last


def count_kernel_launches(fn, device):
    """(kernels launched on the card, their summed device ms) of one call of
    `fn`, from torch.profiler; (None, None) off the card or where the
    profiler records no device event."""
    if device.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "mem" not in e.name.lower()]
    if not kernels:
        return None, None
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def _edgeconv_train_ms(device, B, N, K, iters=5, seed=0):
    """Device ms of train-mode EdgeConv, forward + backward, per train step
    of the flagship net: each main-path width alone at the step's shapes
    (large kernels, so the card and not the host sets the time), weighted by
    its count per forward. None off the card."""
    from checkerpose_tpu_torch.models.graph import EdgeConv
    from checkerpose_tpu_torch.ops.knn import knn_index
    g = torch.Generator().manual_seed(seed)
    knn = torch.as_tensor(knn_index(torch.randn(N, 3, generator=g).numpy(), K), device=device)
    total = 0.0
    for C, count in MAIN_WIDTHS.items():
        mod = EdgeConv(C, C).to(device).train()
        x = torch.randn(B, N, C, generator=g).to(device).requires_grad_()

        def fwd_bwd():
            mod(x, knn).float().sum().backward()

        ms = time_ms(fwd_bwd, device, iters)
        if ms is None:
            return None
        total += count * ms
    return total


# Gate 2's bars on the gradients. At random weights the gradient of a train
# step is not a smooth function of its rounding: each EdgeConv takes B*N*C'
# maxima over K, and where the top two lie closer than the forwards' rounding
# difference the argmax, and with it the route of that entry's gradient,
# differs. The same model in f32 and in f64 on one device differs by a few
# percent for that reason, so the card is held to the CPU by three bars: its
# distance to an f64 run on the CPU (relative L2 over all leaves) is at most
# GRAD_VS_F64_FACTOR times the CPU's own f32 distance to it plus
# GRAD_VS_F64_SLACK; every leaf lies within GRAD_LEAF_TOL of the CPU f32
# leaf's largest entry (a missing gradient reads 1, a wrong sign 2); and all
# leaves together within GRAD_GLOBAL_TOL relative L2 of the CPU f32 run.
GRAD_VS_F64_FACTOR, GRAD_VS_F64_SLACK, GRAD_LEAF_TOL, GRAD_GLOBAL_TOL = 2.0, 1e-3, 0.6, 0.1
# new running statistics, |err| / (1 + |ref|): the f32 forwards of the two
# devices differ in the fifth digit by the deepest layers (measured 1.9e-5)
STAT_TOL = 1e-4


def _rel_l2(a, b):
    """Relative L2 distance of gradient dict a to b over all leaves, and the
    worst leaf's largest error over b's largest entry with that leaf's name."""
    num = den = 0.0
    worst = (0.0, "")
    for name, want in b.items():
        diff = a[name].double() - want.double()
        num += float(diff.norm()) ** 2
        den += float(want.double().norm()) ** 2
        worst = max(worst, (float(diff.abs().max() / want.abs().max().clamp_min(1e-30)), name))
    return (num / den) ** 0.5, worst


def _gate_card_vs_cpu(device, cfg, knn, batch_np, seed):
    """Gate 2: one forward + backward of the train loss from the same
    weights in f32 (TF32 off) on `device` and on the CPU, and in f64 on the
    CPU as the reference both are measured against."""
    from checkerpose_tpu_torch.models.layers import init_params
    from checkerpose_tpu_torch.models.posenet import PoseNet, knn_tensor
    from checkerpose_tpu_torch.train import steps

    def run(dev, dtype):
        net = PoseNet(**cfg, dtype=dtype)
        init_params(net, torch.Generator().manual_seed(seed))
        net.to(dev).train()
        batch = _on(dev, batch_np)
        imgs = steps.device_augment_normalize(batch["image"], None, False, False, train=False)
        total, _ = steps.train_loss(net, knn_tensor(knn, cfg["npoint"], dev), imgs, batch, 3)
        total.backward()
        grads = {n: p.grad.cpu() for n, p in net.named_parameters() if p.grad is not None}
        stats = {n: b.cpu() for n, b in net.named_buffers()}
        return float(total.detach()), grads, stats

    cpu = torch.device("cpu")
    _, grads_64, _ = run(cpu, torch.float64)
    loss_c, grads_c, stats_c = run(cpu, torch.float32)
    loss_d, grads_d, stats_d = run(device, torch.float32)
    if set(grads_c) != set(grads_d):
        raise AssertionError("the card and the CPU gave gradients to different leaves")
    loss_rel = abs(loss_d - loss_c) / abs(loss_c)
    cpu_vs_64, _ = _rel_l2(grads_c, grads_64)
    card_vs_64, _ = _rel_l2(grads_d, grads_64)
    card_vs_cpu, (leaf_err, leaf_name) = _rel_l2(grads_d, grads_c)
    stat_err = max(float(((stats_d[n] - v).abs() / (1.0 + v.abs())).max())
                   for n, v in stats_c.items())
    res = {"loss_cpu": loss_c, "loss_card": loss_d, "loss_rel_err": loss_rel,
           "grad_rel_l2_cpu32_vs_cpu64": cpu_vs_64, "grad_rel_l2_card32_vs_cpu64": card_vs_64,
           "grad_rel_l2_card32_vs_cpu32": card_vs_cpu, "grad_worst_leaf_max_rel": leaf_err,
           "grad_worst_leaf": leaf_name, "running_stat_max_rel_err": stat_err}
    vs_64_bar = GRAD_VS_F64_FACTOR * cpu_vs_64 + GRAD_VS_F64_SLACK
    say(f"[train] gate 2, card vs CPU, f32, batch {len(batch_np['image'])}: loss {loss_d:.6f} vs "
        f"{loss_c:.6f} (rel {loss_rel:.2e}, bar 1e-4); all gradient leaves, relative L2: "
        f"card f32 to CPU f64 {card_vs_64:.2e} (bar {vs_64_bar:.2e} = "
        f"{GRAD_VS_F64_FACTOR:g} x the CPU f32's own {cpu_vs_64:.2e} + {GRAD_VS_F64_SLACK:g}), "
        f"card f32 to CPU f32 {card_vs_cpu:.2e} (bar {GRAD_GLOBAL_TOL:g}); worst leaf "
        f"{leaf_name}: {leaf_err:.2e} of its largest entry (bar {GRAD_LEAF_TOL:g}); running "
        f"statistics max |err| / (1 + |ref|) {stat_err:.2e} (bar {STAT_TOL:g})")
    if loss_rel > 1e-4 or card_vs_64 > vs_64_bar or card_vs_cpu > GRAD_GLOBAL_TOL \
            or leaf_err > GRAD_LEAF_TOL or stat_err > STAT_TOL:
        raise AssertionError(f"gate 2: the card's train step disagrees with the CPU's: {res}")
    return res


def _mark(device):
    """A point on the device's clock: a recorded CUDA event, or the host's
    clock for a CPU rehearsal."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _between_ms(a, b):
    return 1e3 * (b - a) if isinstance(a, float) else a.elapsed_time(b)


class _LayerTimer:
    """Marks around the forward and the backward of every module of the
    given types, by hooks; `ms()` sums them by type name after a sync."""

    def __init__(self, net, types, device, skip_inside=()):
        self.events = []
        self.handles = []
        inside = {id(m) for parent in net.modules() if isinstance(parent, skip_inside)
                  for m in parent.modules() if m is not parent}
        for m in net.modules():
            if isinstance(m, types) and id(m) not in inside:
                name = type(m).__name__
                starts = []

                def begin(*_a, starts=starts):
                    starts.append(_mark(device))

                def end(*_a, starts=starts, name=name):
                    if starts:
                        self.events.append((name, starts.pop(), _mark(device)))

                self.handles += [m.register_forward_pre_hook(begin), m.register_forward_hook(end),
                                 m.register_full_backward_pre_hook(begin),
                                 m.register_full_backward_hook(end)]

    def ms(self):
        out = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + _between_ms(a, b)
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def _profile_train_step(device, state, step, batch, gen, profile_dir):
    """Shares of one train step by layer type (events around each module's
    forward and backward, and around the optimizer's update), and a
    torch.profiler table of the step's kernels."""
    from torch.profiler import ProfilerActivity, profile
    from checkerpose_tpu_torch.models.graph import EdgeConv
    from checkerpose_tpu_torch.models.layers import BatchNorm, Conv2d, ConvTranspose2d

    timer = _LayerTimer(state.module, (EdgeConv, BatchNorm, Conv2d, ConvTranspose2d), device,
                        skip_inside=(EdgeConv,))
    opt_events = []
    opt_step = state.optimizer.step

    def timed_opt_step(*a, **k):
        t0 = _mark(device)
        r = opt_step(*a, **k)
        opt_events.append((t0, _mark(device)))
        return r

    state.optimizer.step = timed_opt_step
    try:
        t0 = _mark(device)
        step(state, batch, gen)
        t1 = _mark(device)
        _sync(device)
    finally:
        state.optimizer.step = opt_step
        timer.remove()
    total = _between_ms(t0, t1)
    parts = timer.ms()
    parts["Adam"] = sum(_between_ms(a, b) for a, b in opt_events)
    shares = {k: {"ms": v, "share": v / total} for k, v in sorted(parts.items())}
    say(f"[train] one hooked step {total:.1f} ms; by layer type, forward + "
        f"backward: " + "; ".join(f"{k} {v['ms']:.1f} ms ({100 * v['share']:.0f}%)"
                                  for k, v in shares.items())
        + " (EdgeConv includes its own BatchNorm; the rest is activations, casts, "
          "upsampling, gathers, losses, augmentation)")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        step(state, batch, gen)
        _sync(device)
    table = prof.key_averages().table(
        sort_by="cuda_time_total" if device.type == "cuda" else "cpu_time_total", row_limit=40)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    (Path(profile_dir) / "train_profile.txt").write_text(table)
    say("[train] profile of one step (top rows by device time):")
    print("\n".join(table.splitlines()[:16]))
    return {"hooked_step_ms": total, "by_layer": shares}


def phase_train(device, batch=32, npoint=512, backbone="hrnet_w18", knn_k=20, steps_n=20,
                loop_steps=24, timed_steps=20, ref_batch=2, seed=0, profile_dir=None,
                ckpt_dir=None):
    """The training path at the flagship width; every gate raises."""
    import shutil
    from checkerpose_tpu_torch.models.init_net import InitNet
    from checkerpose_tpu_torch.models.posenet import PoseNet, knn_tensor
    from checkerpose_tpu_torch.ops.edgeconv import (edgeconv_fused, edgeconv_fused_plain,
                                                    reset_launch_counts)
    from checkerpose_tpu_torch.ops.geometry import pc_normalize
    from checkerpose_tpu_torch.ops.knn import knn_index
    from checkerpose_tpu_torch.models import graph
    from checkerpose_tpu_torch.train import steps
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
    from checkerpose_tpu_torch.train.loop import run_training
    from checkerpose_tpu_torch.train.state import (create_init_state, create_pose_state,
                                                   make_optimizer, param_count)
    from checkerpose_tpu_torch.utils.logging import MetricWriter

    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed + 2)
    p3d = rng.uniform(-40, 40, (npoint, 3))
    p3dn = pc_normalize(p3d).astype(np.float32)
    knn_np = knn_index(p3dn, knn_k)
    knn = knn_tensor(knn_np, npoint, device)
    cfg = dict(npoint=npoint, backbone_name=backbone, **POSENET_CFG)
    batches = _train_batches(rng, 4, batch, p3d, p3dn)
    fixed = _on(device, batches[0])
    res = {"batch": batch, "npoint": npoint, "backbone": backbone}

    # --- gate 1: the steps train --------------------------------------------
    net = PoseNet(**cfg)
    state = create_pose_state(net, make_optimizer(TRAIN_LR), seed=seed, device=device)
    res["params_m"] = param_count(net)
    fwd = steps.make_pose_forward(net, knn, 3)
    net.eval()
    fwd(fixed)                              # an eval forward before training: folds once
    folds_before = [m.folds for m in _edgeconvs(net)]
    net.train()
    step = steps.make_train_step(net, knn, 3, color_aug_prob=0.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    metrics = [step(state, fixed, gen) for _ in range(steps_n)]
    losses = [float(m["loss"]) for m in metrics]
    last = {k: float(v) for k, v in metrics[-1].items()}
    if not np.isfinite(list(last.values())).all():
        raise AssertionError(f"gate 1: non-finite train metrics {last}")
    first5, last5 = _falls(losses, "gate 1, make_train_step(stage=3)")
    res["train_loss_first5_last5"] = [first5, last5]
    say(f"[train] gate 1: {steps_n} steps of make_train_step(stage=3) on one batch, "
        f"{backbone} npoint={npoint} K={knn_k} batch={batch} Adam {TRAIN_LR:g}, "
        f"{res['params_m']:.2f} M parameters: loss mean of first 5 {first5:.4f} -> last 5 "
        f"{last5:.4f}, all metrics finite: {last}")

    init_net = InitNet(npoint, 3, backbone, 1, POSENET_CFG["init_num_graph_module"])
    init_state = create_init_state(init_net, make_optimizer(PRETRAIN_LR), seed=seed,
                                   device=device)
    pre = steps.make_pretrain_step(init_net, knn, PRETRAIN_CROP_GT, color_aug_prob=0.0)
    pre_losses = [float(pre(init_state, fixed, gen)["loss"]) for _ in range(steps_n)]
    first5, last5 = _falls(pre_losses, "gate 1, make_pretrain_step")
    res["pretrain_loss_first5_last5"] = [first5, last5]
    say(f"[train] gate 1: {steps_n} steps of make_pretrain_step on an InitNet (labels at "
        f"{PRETRAIN_CROP_GT}, Adam {PRETRAIN_LR:g}): loss mean of first 5 {first5:.4f} -> "
        f"last 5 {last5:.4f}")
    del init_state, init_net, pre

    # --- gate 3: training reaches the kernel ---------------------------------
    net.eval()
    reset_launch_counts()
    out = fwd(fixed)
    _sync(device)
    by_route = dict(edgeconv_fused.launches_by_route)
    fwd(fixed)                              # a second eval forward folds nothing
    grown = [m.folds - f for m, f in zip(_edgeconvs(net), folds_before)]
    want_routes = {"tc": EDGECONV_PER_FORWARD if on_card else 0, "fma": 0}
    if by_route != want_routes or grown != [1] * EDGECONV_PER_FORWARD:
        raise AssertionError(f"gate 3: after training, the eval forward's launches {by_route} "
                             f"(expected {want_routes}) and refolds per EdgeConv {grown} "
                             f"(expected one each)")
    fused = graph.edgeconv_fused
    graph.edgeconv_fused = lambda x, k, w1, w2m1, s, b, slope, packed=None: \
        edgeconv_fused_plain(x, k, w1, w2m1, s, b, slope)
    try:
        plain = fwd(fixed)
    finally:
        graph.edgeconv_fused = fused
    agree = {k: float((out[k] == plain[k]).float().mean()) for k in ("x_id", "y_id")}
    seg_err = float((out["seg_visib"] - plain["seg_visib"]).abs().max())
    if min(agree.values()) <= 0.95:
        raise AssertionError(f"gate 3: ids through the kernel and through the plain EdgeConv "
                             f"agree on {agree} of keypoints (bar > 0.95)")
    res["eval_after_training"] = {"edgeconv_launches_by_route": by_route, "refolds": grown,
                                  "ids_agree_with_plain": agree, "seg_max_abs_err": seg_err}
    say(f"[train] gate 3: eval forward of the trained weights: EdgeConv launches {by_route}, "
        f"every EdgeConv refolded once ({sum(grown)} folds, none on a second forward); ids "
        f"against the plain EdgeConv agree {agree['x_id']:.4f}/{agree['y_id']:.4f} "
        f"(bar > 0.95), seg max err {seg_err:.3g}")
    net.train()

    # --- gate 2: card against CPU, f32 -------------------------------------------
    small = {k: v[:ref_batch] for k, v in batches[1].items()}
    res["card_vs_cpu"] = _gate_card_vs_cpu(device, cfg, knn_np, small, seed)

    # --- gate 4: loop and checkpoints ----------------------------------------------
    ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else ROOT / "build" / "train_smoke"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(str(ckpt_dir / "ckpt"))
    writer = MetricWriter(str(ckpt_dir / "log"), use_tensorboard=False)
    held = _on(device, batches[3])

    def eval_fn(module):
        pred = steps.make_pose_forward(module, knn, 3)(held)
        roi, x_id, y_id = steps.device_labels(held, 64)
        gx, gy = steps._code_labels_bits(x_id, y_id, 6, 6)
        err = torch.cat([((pred["x_logits"] > 0).float() - gx).abs(),
                         ((pred["y_logits"] > 0).float() - gy).abs()], -1)
        bit_err = float((err * roi).sum() / roi.sum().clamp_min(1.0) / err.shape[-1])
        return {"test_acc": 1.0 - bit_err, "gate_score": 1.0 - bit_err,
                "gate_metric": "one_minus_mean_bit_err"}

    def loader():
        i = 0
        while True:
            yield dict(batches[i % 3])
            i += 1

    loop_step = steps.make_train_step(net, knn, 3)
    start = state.step
    test_freq, save_freq = loop_steps // 2, loop_steps // 4
    state = run_training(state=state, step_fns={3: loop_step}, loader=loader(),
                         total_iteration=start + loop_steps, eval_fn=eval_fn, ckpt=ckpt,
                         writer=writer, log_freq=save_freq, test_freq=test_freq,
                         save_freq=save_freq, get_stage=lambda s: 3, seed=seed)
    writer.close()
    kept = sorted(int(d.name) for d in (ckpt_dir / "ckpt").iterdir() if d.name.isdigit())
    best = sorted(d.name for d in (ckpt_dir / "ckpt" / "best").iterdir())
    if len(kept) != 3 or kept[-1] != state.step or len(best) != 1 \
            or ckpt.best_floor("one_minus_mean_bit_err") != state.best_score:
        raise AssertionError(f"gate 4: rolling checkpoints {kept}, best {best}, best score "
                             f"{state.best_score}")
    net2 = PoseNet(**cfg)
    restored = ckpt.restore(create_pose_state(net2, make_optimizer(TRAIN_LR), seed=seed + 1,
                                              device=device))
    if restored.step != state.step:
        raise AssertionError(f"gate 4: restored step {restored.step}, live {state.step}")
    for (k, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"gate 4: {k} differs after restore")
    live_opt, rest_opt = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, st in live_opt["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(st[k], rest_opt["state"][i][k]):
                raise AssertionError(f"gate 4: Adam's {k} of parameter {i} differs after restore")
    step2 = steps.make_train_step(net2, knn, 3)
    more = []
    for st, fn in ((state, loop_step), (restored, step2)):
        g = torch.Generator(device=device).manual_seed(seed + 5)
        more.append([float(fn(st, _on(device, batches[i]), g)["loss"]) for i in (1, 2)])
    drift = max(float((a - b).abs().max())
                for a, b in zip(net.parameters(), net2.parameters()))
    stat_drift = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                     for a, b in zip(net.buffers(), net2.buffers()))
    # the first step starts from equal bits, so only the order of the card's
    # atomic sums can tell the two apart; after it Adam may have moved a
    # parameter whose gradient is rounding noise by +lr on one side and -lr on
    # the other, so two steps may leave parameters up to 4 lr apart, and the
    # second step's batch statistics follow those parameters
    rel = [abs(a - b) / abs(a) for a, b in zip(*more)]
    if rel[0] > 1e-3 or rel[1] > 1e-2 or drift > 4 * TRAIN_LR + 1e-6 or stat_drift > 1e-2:
        raise AssertionError(f"gate 4: two more steps, live {more[0]} vs restored {more[1]}, "
                             f"largest parameter difference {drift}, largest running "
                             f"statistic difference over 1 + |ref| {stat_drift}")
    res["loop"] = {"steps": loop_steps, "kept": kept, "best": best,
                   "best_score": state.best_score, "two_more_steps": more,
                   "max_param_diff_after_two_steps": drift,
                   "max_stat_rel_diff_after_two_steps": stat_drift}
    say(f"[train] gate 4: run_training {loop_steps} steps from step {start} (save every "
        f"{save_freq}, eval every {test_freq} and at the end): rolling checkpoints {kept}, "
        f"best {best} at gate score {state.best_score:.4f}; restored step {kept[-1]}: "
        f"parameters, BN statistics and Adam moments equal bit for bit; two more steps, live "
        f"{more[0]} vs restored {more[1]} (bars 1e-3, 1e-2 relative), largest "
        f"parameter difference {drift:.2e} (bar 4 lr), running statistic {stat_drift:.2e} of "
        f"1 + |ref| (bar 1e-2)")
    del restored, net2, step2

    # --- timed, with the configured augmentation on ------------------------------------
    gen = torch.Generator(device=device).manual_seed(seed)
    dev_batches = [_on(device, b) for b in batches[:3]]
    for i in range(3):
        loop_step(state, dev_batches[i % 3], gen)
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(timed_steps):
        loop_step(state, dev_batches[i % 3], gen)
    _sync(device)
    dt = time.perf_counter() - t0
    res.update(step_ms=1e3 * dt / timed_steps if on_card else None,
               steps_per_s=timed_steps / dt if on_card else None,
               peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None)
    res["kernel_launches_per_step"], res["device_ms_per_step"] = count_kernel_launches(
        lambda: loop_step(state, dev_batches[0], gen), device)
    res["edgeconv_train_device_ms_per_step"] = _edgeconv_train_ms(device, batch, npoint, knn_k)
    busy = res["device_ms_per_step"] / res["step_ms"] if on_card else None
    say(f"[train] timed: {timed_steps} steps of make_train_step(stage=3), batch {batch}, "
        f"pepper-salt and motion blur on, color_aug_prob 0.8: {res['step_ms']} ms/step, "
        f"{res['steps_per_s']} steps/s, peak {res['peak_mem_gib']} GiB; one profiled step: "
        f"{res['kernel_launches_per_step']} kernel launches, {res['device_ms_per_step']} ms "
        f"of device time (busy share {busy}); train-mode EdgeConv forward + backward alone "
        f"at the step's shapes, 2 x C=64 + 9 x C=256: "
        f"{res['edgeconv_train_device_ms_per_step']} ms")
    if profile_dir is not None:
        res["profile"] = _profile_train_step(device, state, loop_step, dev_batches[0], gen,
                                             profile_dir)
    return res


def phase_fold_cost(device, iters=20):
    """ROADMAP queue 3's open measurement: the host and device time of
    `EdgeConv.fused_args()` at C=C'=256 in bf16 with the folded and packed
    weights kept (eval mode's cache) and without (the cache dropped before
    every call, as every forward did before the cache existed)."""
    from checkerpose_tpu_torch.models.graph import EdgeConv
    mod = EdgeConv(256, 256).to(device).eval()

    def timed(drop):
        for _ in range(2):
            mod.fused_args()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            if drop:
                mod._fused_cache = None
            mod.fused_args()
        _sync(device)
        return 1e3 * (time.perf_counter() - t0) / iters

    kept, dropped = timed(False), timed(True)
    on_card = device.type == "cuda"
    res = {"fused_args_kept_ms": kept if on_card else None,
           "fused_args_refold_ms": dropped if on_card else None}
    say(f"[fold] EdgeConv(256, 256).fused_args() bf16, host clock with a sync, mean of "
        f"{iters}: weights kept {res['fused_args_kept_ms']} ms, refolded every call "
        f"{res['fused_args_refold_ms']} ms; x {EDGECONV_PER_FORWARD} EdgeConvs a forward")
    return res


KERNELS = {
    "tc": dict(name="edgeconv_fused_tc", source="checkerpose_tpu_torch/csrc/edgeconv_tc.cu",
               dtype="bfloat16", phase="serving",
               path="bf16 serving forward (phase serving); also the eval forward of the "
                    "trained weights (phase train)"),
    "fma": dict(name="edgeconv_fused_fma", source="checkerpose_tpu_torch/csrc/edgeconv.cu",
                dtype="float32", phase="reference",
                path="f32 forward (phase reference); the bf16 serving path no longer "
                     "launches this kernel"),
}


def kernel_summary(rows, launches_by_route, train_eval_launches=None):
    """One entry per kernel for the JSON line. `launches` is the count of
    the path that runs the kernel (the serving phase for the tensor-core
    kernel, the reference phase's f32 forward for the FMA kernel);
    `launches_by_path` adds the count of the eval forward that ends the train
    phase, each path counted from 0. Times are per forward of that path: 2
    launches at C=C'=64 + 9 at C=C'=256 in the path's dtype."""
    entries = []
    for route, k in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == route]
        main = [r for r in mine if r["dtype"] == k["dtype"] and not r["ragged"]
                and r["C"] in MAIN_WIDTHS]

        def per_forward(key):
            if any(r[key] is None for r in main):
                return None                      # not measured (no card)
            return sum(MAIN_WIDTHS[r["C"]] * r[key] for r in main)

        bound_by = max(main, key=lambda r: MAIN_WIDTHS[r["C"]] * r["bound_ms"])["bound_by"]
        entries.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": "checkerpose_tpu/ops/pallas_edgeconv.py:79",
            "launches": launches_by_route[route], "launches_on": k["path"],
            "launches_by_path": {k["phase"]: launches_by_route[route],
                                 "train_eval": (train_eval_launches or {}).get(route)},
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"), "bound_by": bound_by,
            "library_ms": None,
            "per": f"one forward: 2 launches at C=C'=64 + 9 at C=C'=256, {k['dtype']}, "
                   f"B={main[0]['B']} N={main[0]['N']} K={main[0]['K']}",
            "shapes": mine,
        })
    return entries


def _check_checkout():
    import checkerpose_tpu_torch
    pkg = Path(checkerpose_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"checkerpose_tpu_torch imported from {pkg}, not from this checkout")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and data")
    ap.add_argument("--profile", default=None, help="write a torch.profiler table here")
    ap.add_argument("--steps", action="store_true",
                    help="also time the tensor-core kernel beside its synchronous-copy build")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        return 1
    _check_checkout()
    from checkerpose_tpu_torch.device import resolve_device
    device = resolve_device("cuda")
    global CARD
    card = CARD = gpu_name_power()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    rows = phase_kernels(device, seed=args.seed)
    if args.steps:
        phase_steps(device, seed=args.seed)
    serving = phase_serving(device, seed=args.seed, profile_dir=args.profile)
    reference = phase_reference(device, seed=args.seed)
    phase_oracle(device, seed=args.seed)
    fold = phase_fold_cost(device)
    train = phase_train(device, seed=args.seed, profile_dir=args.profile)

    launches = {"tc": serving["edgeconv_launches_by_route"]["tc"],
                "fma": reference["f32"]["edgeconv_launches_by_route"]["fma"]}
    print(json.dumps({"serving": serving, "fold": fold, "card": card}))
    print(json.dumps({"train": train, "card": card}))
    print(json.dumps({"kernels": kernel_summary(
        rows, launches, train["eval_after_training"]["edgeconv_launches_by_route"])}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
