#!/usr/bin/env python3
"""Drive the PyTorch port's crop->pose serving path on one NVIDIA GPU.

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
              solver at batch 512: every pose within 3 deg and 10 units.
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
    say(f"[serving] {backbone} npoint={npoint} K=20 stage=3 batch={batch} FAST_PROFILE: "
          f"{res['crops_per_s']} crops/s ({res['batch_ms']} ms/batch over {iters}); "
          f"forward+decode {res['forward_decode_ms']} ms, solver {res['solver_ms']} ms; "
          f"peak {res['peak_mem_gib']} GiB; EdgeConv launches {launches} "
          f"= {EDGECONV_PER_FORWARD} x {iters} forwards, by route {by_route}; R, t finite")

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


def phase_oracle(device, batch=512, npoint=512, S=64, seed=0):
    """Known poses -> exact codes -> port decode + FAST_PROFILE solver."""
    from checkerpose_tpu_torch.eval.decode import ids_to_correspondences
    from checkerpose_tpu_torch.solver.ransac import FAST_PROFILE, solve_poses_batched

    rng = np.random.default_rng(seed)
    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1.0]])
    p3d = rng.uniform(-40, 40, (npoint, 3))
    Q, _ = np.linalg.qr(rng.standard_normal((batch, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    t = np.stack([rng.uniform(-20, 20, batch), rng.uniform(-20, 20, batch),
                  rng.uniform(350, 500, batch)], -1)
    cam = p3d[None] @ Q.transpose(0, 2, 1) + t[:, None]
    proj = cam @ K.T
    uv = proj[..., :2] / proj[..., 2:3]
    side = np.maximum(np.ptp(uv[..., 0], 1), np.ptp(uv[..., 1], 1)) * 1.4
    bbox = np.stack([uv[..., 0].min(1) - side * 0.15, uv[..., 1].min(1) - side * 0.15,
                     side, side], -1)

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


KERNELS = {
    "tc": dict(name="edgeconv_fused_tc", source="checkerpose_tpu_torch/csrc/edgeconv_tc.cu",
               dtype="bfloat16", path="bf16 serving forward (phase serving)"),
    "fma": dict(name="edgeconv_fused_fma", source="checkerpose_tpu_torch/csrc/edgeconv.cu",
                dtype="float32",
                path="f32 forward (phase reference); the bf16 serving path no longer "
                     "launches this kernel"),
}


def kernel_summary(rows, launches_by_route):
    """One entry per kernel for the JSON line. `launches` is the count of
    the path that runs the kernel (the serving phase for the tensor-core
    kernel, the reference phase's f32 forward for the FMA kernel). Times are
    per forward of that path: 2 launches at C=C'=64 + 9 at C=C'=256 in the
    path's dtype."""
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

    launches = {"tc": serving["edgeconv_launches_by_route"]["tc"],
                "fma": reference["f32"]["edgeconv_launches_by_route"]["fma"]}
    print(json.dumps({"serving": serving, "card": card}))
    print(json.dumps({"kernels": kernel_summary(rows, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
