#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: serving to backbone pretraining.

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
              with --profile the shares of the step by layer type;
  7. eval     the test CLI (`checkerpose_tpu_torch.cli.test.main`) at the
              synthetic flagship's width (config/synth/...mlpQuery_synth.txt:
              hrnet_w18, 512 keypoints, K=20, res_log2 6) on a fixture the port
              generates (256 test images, 32 train_real, frame cache only),
              random weights with the seg head's bias centred on the crops,
              batch 64, hard and adaptive with the tau calibrated: (a) report
              keys, rates and the CSV read back; (b) 11 tensor-core EdgeConv
              launches per forward batch; (c) the metrics on the card against
              float64; (d) the f32 harness on the card against the CPU on 8
              images; both kernels against the plain version at the eval
              batch; eval images/s, ms per batch by phase (first batch and
              the rest), launches and device ms of a warm batch, the host
              crop's ms per image, peak memory;
  8. workflow a user's single-object workflow through the CLIs' `main`
              functions on a fixture the port generates (1 object of 2048
              vertices, 2 x 64 test images with depth PNGs, 2 x 128
              train_real): the pretrain CLI (PRETRAIN_CFG, 20 iterations,
              eval every 10), again for 2 with the first run's checkpoint as
              `backbone_pretrain_checkpoint`, the train CLI (EVAL_CFG) from
              the first run's init net for 20 and resumed to 30, the test
              CLI, merge_csv, and eval_bop on a CSV of the GT poses and on
              the test CLI's. Gates: (a) pretrain losses finite, report keys,
              checkpoints, 2 tensor-core launches per eval batch; (b) the
              grafted backbone equals the source bit for bit; (c) the init
              net handoff, losses finite, 11 launches per eval batch, one
              fold per EdgeConv per eval, the best checkpoint on the gate
              score, the resume; (d) the kernel against the plain version on
              the trained net's EdgeConv inputs of one eval batch; (e) GT
              poses score AR 1 (VSD > 0.95), the test CLI's CSV finite ARs in
              [0, 1], batched_bop_errors against float64 on the pairs of a
              CSV of perturbed GT poses (0-20 degrees, 8 mm) and of the test
              CLI's, each with the object's own symmetries and a continuous
              one about z. Prints host ms per iteration without the evals
              (mean, first, median of the later ones), seconds per eval,
              peak memory, MSSD + MSPD device ms and VSD's host ms per
              rendered frame.
  9. lm       the LM multi-object workflow through pretrain_lm, train_lm and
              test_lm at the synthetic LM configs' width (hrnet_w18, 512
              keypoints, K=20, res_log2 6, 3 graph modules per refine stage,
              batch 64) on a fixture the port generates (4 objects, 2 x 128
              train_real and 2 x 32 test images, an lm_imgn tree of 4 x 16
              renders and 2 backgrounds written by the port's own PNG codec),
              real images mixed with lm_imgn renders and the background swap
              on: pretrain_lm 20 iterations, train_lm 20 resumed to 30, test_lm
              hard (adx_type visib) and adaptive (tau calibrated), the woProg
              ablation (4 iterations, test). Every EdgeConv there reads a
              per-sample (B, N, K) graph, which takes the plain per-sample path
              as in the JAX package and launches no kernel. Gates: (a) losses,
              checkpoints under lm13, every eval sweeps all objects, 0 kernel
              launches and 2 per-sample calls a forward batch; (b) the init
              handoff, per-object adx10 and gate scores, the resume, 11
              per-sample calls a batch, batches that mix objects, the
              background swap on lm_imgn samples; (c) the per-sample path
              against the tensor-core kernel launched per object on a static
              graph, on one eval batch's EdgeConv inputs; (d) a multi-object
              train step on the card against the CPU (phase train's bars);
              (e) the test reports, tau on its grid, woProg ids < 64. Prints
              ms per iteration and its ratio to the single-object train CLI,
              peak memory, s per eval, and torch.profiler device ms of the
              per-sample EdgeConv in a train step and an eval forward, beside
              the same inputs through the tensor-core kernel.
 10. backbones the other backbones, the timm import and NOCS pretraining:
              (a) the slice's main path, ServingPipeline as in phase serving on
              a resnet34 PoseNet at batch 512 (crops/s beside hrnet_w18's, ms
              by part, peak memory, launches and device ms a batch); (b)
              hrnet_w30, convnext tiny/small/base and darknet53 at the same
              width, batch 64; (c) each of the six on the card against the
              CPU in f32 (phase reference's bars; ConvNeXt's layer scales
              drawn O(1)); (d) hand-written timm state_dicts of resnet34 and
              hrnet_w18 through the converters into a flagship PoseNet's init
              net, every backbone entry set, a finite forward; (e)
              cli.pretrain_backbone at config/synth/nocs_backbone_synth.txt's
              width (hrnet_w18, head 128, batch 64, 64x64 labels) for 20
              iterations on phase workflow's fixture, the loss falling, the
              on-card rasterizer against the host z-buffer and the NOCS
              labels against float64, then the pretrain CLI grafting its
              checkpoint bit for bit; (f) the test CLI on a resnet34 PoseNet.
              Every bf16 forward launches the tensor-core kernel 11 times (2
              an InitNet eval batch), the f32 ones the FMA kernel, NOCS none.
 11. parallel data parallelism and the native loader: (a) the train CLI
              (EVAL_CFG's width, batch 64, 20 iterations, eval at 10 and 20)
              started as torchrun starts it, world size 1 over NCCL, in a
              process of its own on phase workflow's fixture from its
              pretrained init net: backend and world, losses finite, each
              checkpoint written once, 11 tensor-core launches an eval batch
              (counted in that process and sent back); ms an iteration beside
              phase workflow's single-process train CLI, peak memory; (b) one
              f32 train step of the flagship PoseNet (augmentation and
              teacher forcing on, SGD) on 2 gloo ranks x 4 rows on the one
              card against one process at batch 8, on a batch whose rows hold
              different in-RoI counts: the loss, every parameter and running
              statistic at tests/test_sharding.py's bars (phase train's
              gate-2 bars where near-ties in EdgeConv's max over K flip, the
              flips counted); (c) the test CLI over 512 PNG frames without a
              frame cache on the python path and, where the host has g++,
              png.h and jpeglib.h, on the native core (counters, crops within
              one grey level, the CSVs' rows; else that half is left out with
              the reason): eval images/s and loader wait ms a batch.
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

    # split of a batch, the median of 3: network forward + decode, then the solver
    split = []
    with torch.inference_mode():
        for _ in range(3):
            t1 = time.perf_counter()
            p2d, valid = pipe.correspondences(images, bbox)
            _sync(device)
            t2 = time.perf_counter()
            ransac_pnp(pipe.p3d.expand(batch, npoint, 3), p2d, valid, K.expand(batch, 3, 3),
                       gen, **pipe.solver_kw)
            _sync(device)
            split.append((t2 - t1, time.perf_counter() - t2))
    fwd_s, solver_s = np.median(split, axis=0)

    on_card = device.type == "cuda"
    res = {"batch": batch, "iters": iters, "edgeconv_launches": launches,
           "edgeconv_launches_by_route": by_route,
           "crops_per_s": batch * iters / dt if on_card else None,
           "batch_ms": 1e3 * dt / iters if on_card else None,
           "forward_decode_ms": 1e3 * float(fwd_s) if on_card else None,
           "solver_ms": 1e3 * float(solver_s) if on_card else None,
           "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None,
           "success_rate": float(out["success"].float().mean())}
    res["kernel_launches_per_batch"], res["device_ms_per_batch"] = count_kernel_launches(
        lambda: pipe(images, bbox, K, gen), device)
    say(f"[serving] {backbone} npoint={npoint} K=20 stage=3 batch={batch} FAST_PROFILE: "
          f"{res['crops_per_s']} crops/s ({res['batch_ms']} ms/batch over {iters}); "
          f"forward+decode {res['forward_decode_ms']} ms, solver {res['solver_ms']} ms "
          f"(median of 3); "
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
    agreement reported. A ConvNeXt's layer scales are drawn O(1)
    (`_layer_scales_o1`): at their init, 1e-6, every block is the identity."""
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
        net = _layer_scales_o1(make_posenet(device=dev, seed=seed, dtype=dtype, **cfg), seed)
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


def _layer_scales_o1(net, seed):
    """`net` with every ConvNeXt layer scale (`gamma`) drawn uniform in
    [0.5, 1] from `seed`, the same on every device."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(0.5 + 0.5 * torch.rand(p.shape, generator=g))
    return net


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


def _stack_items(items):
    """Dataset items (dicts of numpy arrays) -> one batch dict."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


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


def _device_kernels(fn, device):
    """[(kernel name, device ms)] of the kernels one call of `fn` launched on
    the card (memory copies and sets left out), from torch.profiler; None
    off the card (fn does not run) or where the profiler records no device
    event."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "mem" not in e.name.lower()] or None


def count_kernel_launches(fn, device):
    """(kernels launched on the card, their summed device ms) of one call of
    `fn`; (None, None) where `_device_kernels` gives None."""
    kernels = _device_kernels(fn, device)
    if kernels is None:
        return None, None
    return len(kernels), sum(ms for _, ms in kernels)


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


def _gate_card_vs_cpu(device, cfg, knn, batch_np, seed, tag="train", gate="gate 2"):
    """Gate 2: one forward + backward of the train loss from the same
    weights in f32 (TF32 off) on `device` and on the CPU, and in f64 on the
    CPU as the reference both are measured against. `knn` is a static graph
    or a stacked table (then batch_np carries obj_idx)."""
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
    say(f"[{tag}] {gate}, card vs CPU, f32, batch {len(batch_np['image'])}: loss {loss_d:.6f} vs "
        f"{loss_c:.6f} (rel {loss_rel:.2e}, bar 1e-4); all gradient leaves, relative L2: "
        f"card f32 to CPU f64 {card_vs_64:.2e} (bar {vs_64_bar:.2e} = "
        f"{GRAD_VS_F64_FACTOR:g} x the CPU f32's own {cpu_vs_64:.2e} + {GRAD_VS_F64_SLACK:g}), "
        f"card f32 to CPU f32 {card_vs_cpu:.2e} (bar {GRAD_GLOBAL_TOL:g}); worst leaf "
        f"{leaf_name}: {leaf_err:.2e} of its largest entry (bar {GRAD_LEAF_TOL:g}); running "
        f"statistics max |err| / (1 + |ref|) {stat_err:.2e} (bar {STAT_TOL:g})")
    if loss_rel > 1e-4 or card_vs_64 > vs_64_bar or card_vs_cpu > GRAD_GLOBAL_TOL \
            or leaf_err > GRAD_LEAF_TOL or stat_err > STAT_TOL:
        raise AssertionError(f"{gate}: the card's train step disagrees with the CPU's: {res}")
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


# the synthetic flagship of the eval phase: hrnet_w18, 512 keypoints, K=20,
# res_log2 6, 3 graph modules per refine stage, aux refine heads
EVAL_CFG = "config/synth/hr18GNN2_res6_gnn3Skip_mlpQuery_synth.txt"
# the keys of the JAX harness's report, as `cli.test.main` returns it in hard
# mode (tests/test_torch_cli_test.py holds this list against the JAX CLI's)
EVAL_REPORT_KEYS = ("bit_err", "decode_mode", "full", "n_images", "none", "poses", "seg_acc",
                    "seg_iou", "test_acc", "visib")
EVAL_ADAPTIVE_KEYS = ("decode_conf_tau", "tau_sweep")
EVAL_MODE_KEYS = ("adx02", "adx05", "adx10", "auc_posecnn", "mean_re_deg", "mean_te_mm",
                  "n_valid_lt6_frac", "n_valid_mean", "re2", "re5", "rete2", "rete5", "te2",
                  "te5")
EVAL_RATE_KEYS = ("adx02", "adx05", "adx10", "n_valid_lt6_frac", "re2", "re5", "rete2",
                  "rete5", "te2", "te5")
# gate (c): the port's f32 metrics against float64 on the same inputs
METRIC_ATOL_MM, METRIC_RTOL, METRIC_RE_DEG = 1e-4, 1e-5, 0.05
# gate (d): card against CPU, both f32, harness with the same seed; seen on
# the card: seg metrics 3.6e-5 apart (one pixel in 8 crops), bit errors and
# correspondence counts equal
EVAL_CARD_CPU_TOL = 2e-3


def _cv2_importable() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _gate_eval_report(report, csv_path, n_images, adaptive):
    """Gate (a): the report's keys, its rates, and the CSV read back."""
    import csv
    want = set(EVAL_REPORT_KEYS) | (set(EVAL_ADAPTIVE_KEYS) if adaptive else set())
    if set(report) != want:
        raise AssertionError(f"gate (a): report keys {sorted(report)}, expected {sorted(want)}")
    if report["n_images"] != n_images:
        raise AssertionError(f"gate (a): n_images {report['n_images']}, expected {n_images}")
    for mode in ("none", "full", "visib"):
        if set(report[mode]) != set(EVAL_MODE_KEYS):
            raise AssertionError(f"gate (a): {mode} keys {sorted(report[mode])}")
        bad = {k: report[mode][k] for k in EVAL_RATE_KEYS if not 0.0 <= report[mode][k] <= 1.0}
        if bad:
            raise AssertionError(f"gate (a): {mode} rates outside [0, 1]: {bad}")
    for k in ("seg_acc", "seg_iou", "test_acc"):
        if not 0.0 <= report[k] <= 1.0:
            raise AssertionError(f"gate (a): {k} = {report[k]} outside [0, 1]")
    with open(csv_path) as f:
        rows = list(csv.reader(f))[1:]
    scored = [p for p in report["poses"] if p["score"] != -1]
    if len(rows) != len(scored):
        raise AssertionError(f"gate (a): {len(rows)} CSV rows for {len(scored)} scored images")
    R = np.array([r[4].split() for r in rows], np.float64).reshape(-1, 3, 3)
    t = np.array([r[5].split() for r in rows], np.float64).reshape(-1, 3)
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        raise AssertionError("gate (a): non-finite R or t in the CSV")
    ortho = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max()) if len(R) else 0.0
    if ortho > 1e-4:
        raise AssertionError(f"gate (a): CSV rotations off orthonormal by {ortho}")
    return {"csv_rows": len(rows), "max_orthonormality_err": ortho}


def _gate_eval_metrics(device, n_poses, n_points, seed):
    """Gate (c): batched_pose_errors on `device` (f32) against float64: ADD
    in numpy, ADI by torch.cdist in float64 (an independent algorithm), re
    from the f64 trace; GT poses give 0; a symmetric estimate under sym_rots
    gives re ~ 0."""
    from checkerpose_tpu_torch.eval.metrics import batched_pose_errors
    rng = np.random.default_rng(seed + 7)
    pts = rng.uniform(-60, 60, (n_points, 3)).astype(np.float32)
    Q, _ = np.linalg.qr(rng.standard_normal((2 * n_poses, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    R_gt, R_far = Q[:n_poses], Q[n_poses:]
    # half the estimates within ~1 deg of the GT (Rodrigues), half anywhere
    w = rng.normal(0, 0.01, (n_poses, 3))
    ang = np.linalg.norm(w, axis=1)[:, None, None]
    k = np.zeros((n_poses, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    k -= k.transpose(0, 2, 1)
    k /= ang
    near = (np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)) @ R_gt
    half = n_poses // 2
    R_est = np.concatenate([near[:half], R_far[half:]]).astype(np.float32)
    t_gt = np.stack([rng.uniform(-60, 60, n_poses), rng.uniform(-60, 60, n_poses),
                     rng.uniform(350, 550, n_poses)], -1)
    t_est = (t_gt + rng.normal(0, 3.0, (n_poses, 3))).astype(np.float32)
    R_gt, t_gt = R_gt.astype(np.float32), t_gt.astype(np.float32)
    on = [torch.as_tensor(a, device=device) for a in (R_est, t_est, R_gt, t_gt, pts)]
    p64 = pts.astype(np.float64)
    pe = np.einsum("vk,bjk->bvj", p64, R_est.astype(np.float64)) + t_est[:, None].astype(np.float64)
    pg = np.einsum("vk,bjk->bvj", p64, R_gt.astype(np.float64)) + t_gt[:, None].astype(np.float64)
    ref = {"add": np.linalg.norm(pe - pg, axis=-1).mean(-1),
           "te": np.linalg.norm(t_est.astype(np.float64) - t_gt, axis=-1),
           "re": np.degrees(np.arccos(np.clip(
               (np.einsum("bij,bij->b", R_est.astype(np.float64), R_gt) - 1) / 2, -1, 1)))}
    pe_d, pg_d = torch.as_tensor(pe, device=device), torch.as_tensor(pg, device=device)
    ref["adi"] = np.array([float(torch.cdist(pg_d[b], pe_d[b]).amin(1).mean())
                           for b in range(n_poses)])
    del pe_d, pg_d
    res = {}
    for name, use_adi in (("add", False), ("adi", True)):
        got = {k: v.double().cpu().numpy() for k, v in batched_pose_errors(
            *on, use_adi=use_adi).items()}
        err = np.abs(got["adx"] - ref[name])
        res[f"{name}_max_abs_err_mm"] = float(err.max())
        if (err > METRIC_ATOL_MM + METRIC_RTOL * np.abs(ref[name])).any():
            raise AssertionError(f"gate (c): {name.upper()} off the float64 reference by up to "
                                 f"{err.max()} mm")
    res["te_max_abs_err_mm"] = float(np.abs(got["te"] - ref["te"]).max())
    res["re_max_abs_err_deg"] = float(np.abs(got["re"] - ref["re"]).max())
    if res["te_max_abs_err_mm"] > METRIC_ATOL_MM + METRIC_RTOL * ref["te"].max() \
            or res["re_max_abs_err_deg"] > METRIC_RE_DEG:
        raise AssertionError(f"gate (c): te / re off the float64 reference: {res}")
    zero = batched_pose_errors(on[2], on[3], on[2], on[3], on[4], use_adi=True)
    zero_add = batched_pose_errors(on[2], on[3], on[2], on[3], on[4])
    res["gt_pose_max"] = {"adi": float(zero["adx"].max()), "add": float(zero_add["adx"].max()),
                          "te": float(zero["te"].max()), "re_deg": float(zero["re"].max())}
    if max(res["gt_pose_max"]["adi"], res["gt_pose_max"]["add"], res["gt_pose_max"]["te"]) != 0 \
            or res["gt_pose_max"]["re_deg"] > METRIC_RE_DEG:
        raise AssertionError(f"gate (c): GT poses do not give 0: {res['gt_pose_max']}")
    flip = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)      # 180 deg about z
    sym = torch.as_tensor(np.stack([np.eye(3, dtype=np.float32), flip]), device=device)
    R_sym = on[2] @ sym[1]
    sym_re = batched_pose_errors(R_sym, on[3], on[2], on[3], on[4], sym_rots=sym)["re"]
    res["sym_re_max_deg"] = float(sym_re.max())
    if res["sym_re_max_deg"] > METRIC_RE_DEG:
        raise AssertionError(f"gate (c): symmetric poses give re {res['sym_re_max_deg']} deg")
    return res


def _first_test_batch(cfg, n_images):
    """(keypoints (N, 3), knn, the first batch of `n_images` test crops with
    the normalised keypoints), as the test CLI's loader gives them."""
    from checkerpose_tpu_torch.cli import common
    xyz, normed, knn = common.load_keypoints(cfg)
    loader, _ = common.build_test_loader(cfg, xyz, batch_size=n_images)
    return xyz, knn, next(iter(common.with_p3d(loader, normed.astype(np.float32))))


def _restored_net(cfg, npoint, device, dtype=torch.bfloat16):
    """The PoseNet of the eval phase's best checkpoint, in eval mode."""
    from checkerpose_tpu_torch.cli.train import build_pose_net
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
    net = build_pose_net(cfg, npoint, dtype=dtype)
    net.load_state_dict(CheckpointManager(cfg["ckpt_dir"]).restore_raw(best=True)["model"])
    return net.to(device).eval()


def _gate_eval_card_vs_cpu(device, cfg, n_images, seed):
    """Gate (d): the harness over the first `n_images` test images in f32
    on `device` and on the CPU, from the saved weights and the same seed:
    seg metrics, bit errors and the filters' correspondence counts agree."""
    from checkerpose_tpu_torch.cli import common
    from checkerpose_tpu_torch.eval.harness import evaluate_pipeline

    xyz, knn, batch = _first_test_batch(cfg, n_images)
    out = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        net = _restored_net(cfg, len(xyz), dev, dtype=torch.float32)
        out[name] = evaluate_pipeline(net, knn, [batch], xyz, common.object_diameter(cfg),
                                      stage=net.num_refine_steps, seed=seed,
                                      **common.solver_kwargs(cfg))
    a, b = out["card"], out["cpu"]
    diff = {"seg_acc": abs(a["seg_acc"] - b["seg_acc"]),
            "seg_iou": abs(a["seg_iou"] - b["seg_iou"]),
            "bit_err": float(np.abs(np.subtract(a["bit_err"], b["bit_err"])).max()),
            "n_valid_mean_rel": max(abs(a[m]["n_valid_mean"] - b[m]["n_valid_mean"])
                                    / max(1.0, b[m]["n_valid_mean"])
                                    for m in ("none", "full", "visib"))}
    if max(diff.values()) > EVAL_CARD_CPU_TOL:
        raise AssertionError(f"gate (d): the card's f32 harness disagrees with the CPU's: "
                             f"{diff} (bar {EVAL_CARD_CPU_TOL})")
    return {"images": n_images, "diff": diff,
            "card": {k: a[k] for k in ("seg_acc", "seg_iou")},
            "cpu": {k: b[k] for k in ("seg_acc", "seg_iou")}}


def _balance_seg_head(net, cfg, device, n_images=8):
    """Centre the random seg head on the first test crops: its bias minus the
    median of its logits there, per channel, so about half of a crop reads
    as object. Untouched, the random head calls no pixel object: the visib
    filter keeps no correspondence and the seg metrics compare zeros."""
    from checkerpose_tpu_torch.models.posenet import knn_tensor
    from checkerpose_tpu_torch.train import steps

    xyz, knn, batch = _first_test_batch(cfg, n_images)
    logits = []
    hook = net.seg_block.register_forward_hook(lambda m, i, o: logits.append(o.float()))
    try:
        net.eval()
        steps.make_pose_forward(net, knn_tensor(knn, len(xyz), device), net.num_refine_steps)(
            {k: torch.as_tensor(batch[k], device=device) for k in ("image", "p3d_normed")})
    finally:
        hook.remove()
        net.train()
    with torch.no_grad():
        net.seg_block.bias -= logits[0].transpose(0, 1).reshape(logits[0].shape[1], -1) \
            .median(1).values.to(net.seg_block.bias.dtype)


def _split_spans(spans, n_images):
    """Per-batch host seconds of the harness's phases -> ms per batch over
    every batch and over the batches after the first (the first pays the
    card's one-time set-up: cuDNN's algorithm choice, the EdgeConv folds),
    and images/s over each."""
    first = {k: 1e3 * v[0] for k, v in spans.items()}
    rest = {k: 1e3 * float(np.mean(v[1:])) if len(v) > 1 else None for k, v in spans.items()}
    n_batches = len(spans["forward_decode"])
    total = sum(sum(v) for v in spans.values())
    per_image_rest = (sum(rest.values()) / 1e3 * n_batches / n_images
                      if n_batches > 1 else None)
    return {"ms_per_batch": {k: 1e3 * float(np.mean(v)) for k, v in spans.items()},
            "ms_first_batch": first, "ms_per_batch_after_first": rest,
            "images_per_s": n_images / total,
            "images_per_s_after_first": 1.0 / per_image_rest if per_image_rest else None}


def _host_crop_ms(cfg, n_items):
    """ms per test item of the crop dataset on one host thread (frame-cache
    read, crop and numpy resize of image and masks, projection): what the
    loader's prefetch thread spends per image."""
    from checkerpose_tpu_torch.cli import common
    xyz, _, _ = common.load_keypoints(cfg)
    loader, _ = common.build_test_loader(cfg, xyz, batch_size=1)
    t0 = time.perf_counter()
    for i in range(n_items):
        loader.ds[i]
    return 1e3 * (time.perf_counter() - t0) / n_items


def _eval_warm_batch(device, cfg, batch_size, seed, repeats=3):
    """One warm batch of the hard sweep (forward, decode, solver, metrics)
    from a list, so no loader thread runs beside it: host ms per phase
    (mean of `repeats`, device synchronised at each phase's end; None off
    the card), then the kernels it launches and their device ms from
    torch.profiler."""
    from checkerpose_tpu_torch.cli import common
    from checkerpose_tpu_torch.eval.harness import evaluate_pipeline

    xyz, knn, batch = _first_test_batch(cfg, batch_size)
    net = _restored_net(cfg, len(xyz), device)

    def run(spans=None):
        evaluate_pipeline(net, knn, [batch], xyz, common.object_diameter(cfg),
                          stage=net.num_refine_steps, seed=seed, spans=spans,
                          **common.solver_kwargs(cfg))
    run()
    spans = {}
    for _ in range(repeats):
        run(spans)
    host_ms = {k: 1e3 * float(np.mean(v)) if device.type == "cuda" else None
               for k, v in spans.items() if k != "loader"}
    return host_ms, *count_kernel_launches(run, device)


def phase_eval(device, root=None, n_test=128, n_calib=16, n_scenes=2, batch=64,
               n_vertices=2048, cfg_overrides=None, metric_poses=512, metric_points=8192,
               ref_images=8, seed=0):
    """The evaluation entry point `cli.test.main` at the synthetic flagship's
    width on a fixture the port generates (n_scenes x n_test test images,
    n_scenes x n_calib train_real images for the tau calibration), hard and
    adaptive with the tau calibrated; gates (a)-(d) raise."""
    import shutil
    from checkerpose_tpu_torch.cli import common, test as cli_test
    from checkerpose_tpu_torch.cli.train import build_pose_net
    from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
    from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer

    on_card = device.type == "cuda"
    root = Path(root) if root is not None else ROOT / "build" / "eval_smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_bop(str(root / "data"), n_objects=1, n_scenes=n_scenes,
                       folders={"test": n_test, "train_real": n_calib},
                       n_vertices=n_vertices, raw_cache=True, write_png=False, seed=seed)
    gen_s = time.perf_counter() - t0
    res = {"fixture_s": gen_s if on_card else None, "cv2_importable": _cv2_importable(),
           "fixture": {"test_images": n_scenes * n_test, "calib_images": n_scenes * n_calib,
                       "vertices": n_vertices}}
    say(f"[eval] fixture: {n_scenes} x {n_test} test + {n_scenes} x {n_calib} train_real "
        f"images, {n_vertices} vertices, frame cache only, generated in {res['fixture_s']} s "
        f"on the host; cv2 importable: {res['cv2_importable']}")

    data = str(root / "data")
    cfg = common.resolve_cfg(str(ROOT / EVAL_CFG), "obj01", dict(
        cfg_overrides or {}, bop_path=data,
        Detection_reaults=f"{data}/detection_results/synth/synth_detections.json",
        ckpt_dir=str(root / "ckpt"), eval_output_path=str(root / "out"),
        test_batch_size=batch, device=device.type))
    npoint = 2 ** int(cfg["num_p3d_log2"])
    net = build_pose_net(cfg, npoint)
    state = create_pose_state(net, make_optimizer(1e-4), seed=seed, device=device)
    _balance_seg_head(net, cfg, device)
    CheckpointManager(cfg["ckpt_dir"]).save_best(state)
    del net, state

    n_images = n_scenes * n_test
    csv_path = root / "out" / f"{Path(EVAL_CFG).stem}_obj01.csv"
    test_batches = -(-n_images // batch)
    calib_batches = 5 * -(-min(32, n_scenes * n_calib) // 16)     # 5 taus, val slice at 16
    for mode, forwards in (("hard", test_batches), ("adaptive", calib_batches + test_batches)):
        run_cfg = dict(cfg, decode_mode=mode, decode_tau_auto=(mode == "adaptive") or None)
        spans = {} if mode == "hard" else None
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        report = cli_test.main(run_cfg, spans=spans)
        _sync(device)
        wall = time.perf_counter() - t0
        by_route = dict(edgeconv_fused.launches_by_route)
        want = {"tc": EDGECONV_PER_FORWARD * forwards if on_card else 0, "fma": 0}
        if by_route != want:
            raise AssertionError(f"gate (b): {mode} run's EdgeConv launches {by_route}, "
                                 f"expected {want} ({EDGECONV_PER_FORWARD} x {forwards} "
                                 f"forward batches, all on the tensor-core route)")
        run = {"cli_wall_s": wall if on_card else None, "forward_batches": forwards,
               "edgeconv_launches_by_route": by_route,
               **_gate_eval_report(report, csv_path, n_images, mode == "adaptive"),
               "adx10": {m: report[m]["adx10"] for m in ("none", "full", "visib")},
               "n_valid_mean": {m: report[m]["n_valid_mean"] for m in ("none", "full", "visib")},
               "seg_acc": report["seg_acc"], "seg_iou": report["seg_iou"]}
        if mode == "hard":
            split = _split_spans(spans, n_images)
            if not on_card:                              # no device number off the card
                split = {k: ({m: None for m in v} if isinstance(v, dict) else None)
                         for k, v in split.items()}
            run.update(split, peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                                            if on_card else None))
            say(f"[eval] hard: cli.test.main over {n_images} images at batch {batch}: "
                f"{run['images_per_s']} images/s over the sweep, "
                f"{run['images_per_s_after_first']} after the first batch "
                f"({run['cli_wall_s']} s for the whole CLI call); ms per batch (host clock, "
                f"device synchronised at each phase's end): mean {run['ms_per_batch']}, first "
                f"{run['ms_first_batch']}, after the first {run['ms_per_batch_after_first']}; "
                f"peak {run['peak_mem_gib']} GiB; EdgeConv launches {by_route} = "
                f"{EDGECONV_PER_FORWARD} x {forwards} forward batches")
        else:
            run.update(tau=report["decode_conf_tau"], tau_sweep=report["tau_sweep"])
            say(f"[eval] adaptive, tau calibrated on {min(32, n_scenes * n_calib)} train_real "
                f"images: tau {run['tau']} (sweep {run['tau_sweep']}); {run['cli_wall_s']} s "
                f"for the CLI call; EdgeConv launches {by_route} = {EDGECONV_PER_FORWARD} x "
                f"{forwards} forward batches")
        say(f"[eval] gate (a) {mode}: report keys, rates in [0, 1], {run['csv_rows']} CSV rows "
            f"with finite R, t (orthonormal to {run['max_orthonormality_err']:.2e}); adx10 "
            f"{run['adx10']}, seg_acc {run['seg_acc']:.4f}, seg_iou {run['seg_iou']:.4f}")
        res[mode] = run

    res["host_crop_ms_per_image"] = _host_crop_ms(cfg, min(n_images, 64)) if on_card else None
    res["warm_batch_ms"], res["batch_launches"], res["batch_device_ms"] = _eval_warm_batch(
        device, cfg, batch, seed)
    say(f"[eval] one warm batch of {batch} from a list (no loader thread): ms by phase "
        f"(host clock, device synchronised) {res['warm_batch_ms']}; {res['batch_launches']} "
        f"kernel launches, {res['batch_device_ms']} ms of device time (profiler); the crop "
        f"dataset takes {res['host_crop_ms_per_image']} ms an image on one host thread")

    # the kernels at the shapes this path gives them (its batch), against
    # the plain version; after the runs, so none of these launches counts
    res["kernel_rows"] = phase_kernels(device, B=batch, N=npoint, K=int(cfg["network_graph_k"]),
                                       seed=seed)

    res["metrics_vs_f64"] = _gate_eval_metrics(device, metric_poses, metric_points, seed)
    say(f"[eval] gate (c): metrics on {device.type}, f32, {metric_poses} poses x "
        f"{metric_points} points against float64 (bars {METRIC_ATOL_MM:g} mm + "
        f"{METRIC_RTOL:g} relative, re {METRIC_RE_DEG} deg): {res['metrics_vs_f64']}")
    res["card_vs_cpu"] = _gate_eval_card_vs_cpu(device, cfg, ref_images, seed)
    say(f"[eval] gate (d): harness card vs CPU, f32, first {ref_images} test images: "
        f"{res['card_vs_cpu']['diff']} (bar {EVAL_CARD_CPU_TOL})")
    return res


# the workflow phase: the synthetic flagship's pretraining config (hrnet_w18,
# 512 keypoints, K=20, res_log2 3, GT crop 128, batch 64, Adam 2e-4) and its
# training config, EVAL_CFG (the network of the eval phase, stage 3, aux
# refine heads, teacher forcing 0.5, coordinate regression 0.25, batch 64,
# adaptive decode tau 5)
PRETRAIN_CFG = "config/synth/init_gnn2_hrnetw18_npt512_synth.txt"
INIT_EDGECONVS = 2                  # EdgeConv launches per InitNet forward (C=64)
INIT_EVAL_KEYS = ("acc_mask", "acc_x", "acc_y", "bit_err", "test_acc")
GATE_METRIC = "one_minus_mean_bit_err"
# gate (e): batched_bop_errors (f32, on the card) against float64 numpy
BOP_ERR_RTOL, BOP_ERR_ATOL = 1e-4, 1e-3


class _Tee:
    """Copies what is printed into a list of lines while it goes through."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def lines(self):
        return "".join(self.text).splitlines()


def _wrapped(owner, name, wrap):
    """Within the block, `owner.name` is `wrap(original)`."""
    from unittest import mock
    return mock.patch.object(owner, name, wrap(getattr(owner, name)))


def _run_cli(device, main, cfg, eval_owner, eval_name, timed_owner):
    """One CLI run, counted from 0: its printed lines, returned value, and
    (unless `eval_owner` is None) per eval the EdgeConv launches by route
    and calls of the per-sample path, forward batches, the objects
    (obj_idx) they held, folds per EdgeConv, the report, its start and the
    seconds (the card synchronised);
    the host seconds inside run_training, the host clock at the entry of
    every training step, the objects of each training batch and the peak
    device memory."""
    from contextlib import redirect_stdout
    from checkerpose_tpu_torch.ops.edgeconv import (edgeconv_eval_per_sample, edgeconv_fused,
                                                    reset_launch_counts)

    evals, loop_s, stamps, step_objects = [], [], [], []

    def count_eval(orig):
        def wrapped(net, knn, variables_or_loader, *a, **k):
            # evaluate_init(net, knn, loader, ...) / evaluate_pipeline(net, knn, loader, ...)
            batches, objects = [], set()

            def counted(loader):
                for b in loader:
                    batches.append(1)
                    n_real = int(b.get("n_real", len(b["image"])))
                    objects.update(np.unique(b["obj_idx"][:n_real]).tolist())
                    yield b
            convs = _edgeconvs(net)
            folds = [m.folds for m in convs]
            before = dict(edgeconv_fused.launches_by_route)
            per_sample = edgeconv_eval_per_sample.calls
            _sync(device)
            t0 = time.perf_counter()
            rep = orig(net, knn, counted(variables_or_loader), *a, **k)
            _sync(device)
            evals.append({"start": t0, "seconds": time.perf_counter() - t0,
                          "batches": len(batches), "objects": sorted(objects),
                          "launches": {r: edgeconv_fused.launches_by_route[r] - before[r]
                                       for r in before},
                          "per_sample": edgeconv_eval_per_sample.calls - per_sample,
                          "folds": [m.folds - f for m, f in zip(convs, folds)],
                          "report": rep})
            return rep
        return wrapped

    def stamped(step):
        def wrapped(state, batch, *a, **k):
            stamps.append(time.perf_counter())
            if "obj_idx" in batch:
                step_objects.append(len(torch.unique(batch["obj_idx"])))
            return step(state, batch, *a, **k)
        return wrapped

    def timed_loop(orig):
        def wrapped(**kw):
            kw["step_fns"] = {stage: stamped(f) for stage, f in kw["step_fns"].items()}
            t0 = time.perf_counter()
            try:
                return orig(**kw)
            finally:
                _sync(device)
                loop_s.append(time.perf_counter() - t0)
        return wrapped

    tee = _Tee(sys.stdout)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    from contextlib import nullcontext
    timed = _wrapped(timed_owner, "run_training", timed_loop) if timed_owner else nullcontext()
    counted = _wrapped(eval_owner, eval_name, count_eval) if eval_owner else nullcontext()
    with counted, timed, redirect_stdout(tee):
        out = main(cfg)
    _sync(device)
    launches = dict(edgeconv_fused.launches_by_route)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None
    return {"lines": tee.lines(), "out": out, "evals": evals,
            "loop_s": loop_s[0] if loop_s else None, "stamps": stamps,
            "step_objects": step_objects, "launches": launches,
            "per_sample": edgeconv_eval_per_sample.calls, "peak_mem_gib": peak}


def _logged_losses(lines):
    """The `loss=` values of the loop's step lines."""
    return [float(w[len("loss="):]) for ln in lines if ln.startswith("step ")
            for w in ln.split() if w.startswith("loss=")]


def _gate_launches(run, per_batch, what, folds_per_eval=None):
    """Every eval of a CLI run launched the tensor-core kernel `per_batch`
    times a forward batch and the FMA kernel never, the run's total is the
    sum of its evals' (training steps launch neither), and, when asked,
    every EdgeConv folded `folds_per_eval` times in each eval."""
    total = {"tc": 0, "fma": 0}
    for i, ev in enumerate(run["evals"]):
        want = {"tc": per_batch * ev["batches"], "fma": 0}
        if ev["launches"] != want:
            raise AssertionError(f"{what}: eval {i} launched {ev['launches']} for "
                                 f"{ev['batches']} batches, expected {want}")
        if folds_per_eval is not None and ev["folds"] != [folds_per_eval] * len(ev["folds"]):
            raise AssertionError(f"{what}: eval {i} folded the EdgeConvs {ev['folds']} times, "
                                 f"expected {folds_per_eval} each")
        total = {r: total[r] + ev["launches"][r] for r in total}
    if run["launches"] != total:
        raise AssertionError(f"{what}: the run launched {run['launches']}, its evals {total}")
    return total


def _ms_per_iter(run, iters):
    """Host ms per training iteration: "mean", over run_training with the
    evals' seconds taken out (the first iteration's set-up, checkpoint saves,
    loader waits and logging stay in); "first", from the first step's entry
    to the second's; "median_later", the median of the later intervals
    between step entries that hold no eval (nor the checkpoint save before
    it); "later", how many those are."""
    st = run["stamps"]
    later = [1e3 * (b - a) for i, (a, b) in enumerate(zip(st, st[1:]))
             if i > 0 and not any(a <= e["start"] < b for e in run["evals"])]
    return {"mean": 1e3 * (run["loop_s"] - sum(e["seconds"] for e in run["evals"])) / iters,
            "first": 1e3 * (st[1] - st[0]),
            "median_later": float(np.median(later)) if later else None, "later": len(later)}


def _bop_errors_f64(Re, te, Rg, tg, K, pts, sym_R, sym_t):
    """MSSD and MSPD in float64 numpy, from the two posed clouds and their
    projections: the independent reference of gate (e)."""
    p = pts.astype(np.float64)
    out = {"mssd": [], "mspd": []}

    def proj(cam, k):
        z = np.maximum(cam[..., 2], 1e-6)
        return np.stack([k[0, 0] * cam[..., 0] / z + k[0, 2],
                         k[1, 1] * cam[..., 1] / z + k[1, 2]], -1)
    for i in range(len(Re)):
        re, tt, rg, tgg, k = (np.asarray(a, np.float64) for a in (Re[i], te[i], Rg[i], tg[i], K[i]))
        pe = p @ re.T + tt
        # GT poses composed with each symmetry: (S, V, 3)
        pg = np.einsum("vk,sjk->svj", p, np.einsum("ij,sjk->sik", rg, sym_R.astype(np.float64))) \
            + (sym_t.astype(np.float64) @ rg.T + tgg)[:, None]
        out["mssd"].append(np.linalg.norm(pe[None] - pg, axis=-1).max(-1).min())
        out["mspd"].append(np.linalg.norm(proj(pe, k)[None] - proj(pg, k), axis=-1).max(-1).min())
    return {k: np.array(v) for k, v in out.items()}


def _write_pose_csv(path, rows):
    """A BOP19 CSV of (scene_id, im_id, R, t) rows of object 1, score 1."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for sc, im, R, t in rows:
            f.write(f"{sc},{im},1,1.0,{' '.join(repr(float(x)) for x in np.ravel(R))},"
                    f"{' '.join(repr(float(x)) for x in t)},-1\n")


def _perturbed(R, t, rng):
    """R, t turned by 0-20 degrees about a random axis and moved by a
    normal 8 mm a coordinate: errors at the scale of the recall thresholds."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.deg2rad(rng.uniform(0, 20))
    return (np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k) @ R, t + rng.normal(0, 8.0, 3)


def _gate_bop_errors(device, csvs, data, iters=10):
    """Gate (e), last part: batched_bop_errors on `device` against float64
    numpy on the pairs of each CSV in `csvs` (every estimate against the GT
    of its image) over the object's eval-model vertices, with its own
    symmetries (none) and with a continuous symmetry about z capped at 64;
    per case the float64 errors' median, the largest deviation and the
    device ms from CUDA events."""
    from checkerpose_tpu_torch.data.bop_io import (load_models_info, model_ply_path,
                                                   scan_bop_object)
    from checkerpose_tpu_torch.data.ply import load_ply_vertices
    from checkerpose_tpu_torch.eval import bop_scores as B
    gts = {(s.scene_id, s.im_id): s for s in scan_bop_object(data, "synth", "test", 1, -1.0)}
    verts = load_ply_vertices(model_ply_path(data, "synth", 1, eval_models=True)).astype(np.float32)
    info = load_models_info(data, "synth", eval_models=True)[1]
    res = {}
    for csv_name, csv_path in csvs.items():
        rows = [r for r in B.load_bop_results_csv(csv_path) if (r["scene_id"], r["im_id"]) in gts]
        g = [gts[(r["scene_id"], r["im_id"])] for r in rows]
        arrays = [np.stack(a).astype(np.float32) for a in
                  ([r["R"] for r in rows], [r["t"] for r in rows], [s.R for s in g],
                   [s.t for s in g], [s.cam_K for s in g])]
        for name, minfo in (("own", info),
                            ("continuous_z", dict(info, symmetries_continuous=[
                                {"axis": [0, 0, 1], "offset": [0, 0, 0]}]))):
            sym_R, sym_t = B.sym_arrays(minfo)
            on = [torch.as_tensor(a, device=device) for a in (*arrays, verts, sym_R, sym_t)]
            got = {k: v.double().cpu().numpy() for k, v in B.batched_bop_errors(*on).items()}
            ref = _bop_errors_f64(*arrays, verts, sym_R, sym_t)
            err = {k: np.abs(got[k] - ref[k]) for k in got}
            bad = {k: int((e > BOP_ERR_ATOL + BOP_ERR_RTOL * np.abs(ref[k])).sum())
                   for k, e in err.items()}
            case = f"{csv_name}/{name}"
            res[case] = {"pairs": len(rows), "verts": len(verts), "syms": len(sym_R),
                         "median": {k: float(np.median(v)) for k, v in ref.items()},
                         "diameter": float(info["diameter"]),
                         "max_abs_err": {k: float(e.max()) for k, e in err.items()},
                         "max_rel_err": {k: float((e / np.maximum(np.abs(ref[k]), 1e-30)).max())
                                         for k, e in err.items()},
                         "device_ms": time_ms(lambda: B.batched_bop_errors(*on), device, iters)}
            if any(bad.values()):
                raise AssertionError(f"gate (e): batched_bop_errors off float64 on {bad} of "
                                     f"{len(rows)} pairs ({case}): {res[case]}")
    return res


def _score_csv(device, eval_bop, csv_path, data):
    """eval_bop.main on a CSV, with the MSSD + MSPD call timed on the host
    clock (the device synchronised) and VSD timed and its rendered depth
    maps counted from outside the CLI."""
    from checkerpose_tpu_torch.eval import bop_scores as B
    t = {"errors_s": 0.0, "vsd_s": 0.0, "vsd_renders": 0}

    def timed(key, sync=False):
        def wrap(orig):
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    if sync:
                        _sync(device)
                    t[key] += time.perf_counter() - t0
            return wrapped
        return wrap

    def sized(orig):
        def wrapped(Re, te, Rg, tg, K, pts, sym_R, sym_t, **k):
            t.update(pairs=len(Re), verts=len(pts), syms=len(sym_R))
            return orig(Re, te, Rg, tg, K, pts, sym_R, sym_t, **k)
        return wrapped

    def counted(orig):
        def wrapped(*a, **k):
            t["vsd_renders"] += 1
            return orig(*a, **k)
        return wrapped

    with _wrapped(B, "batched_bop_errors", lambda f: sized(timed("errors_s", sync=True)(f))), \
            _wrapped(eval_bop, "_try_vsd", timed("vsd_s")), \
            _wrapped(B, "render_depth", counted):
        rep = eval_bop.main(str(csv_path), data, "synth", device=device.type)
    return {"overall": rep["overall"], "per_object": rep["per_object"][1], **t}


def _gate_kernel_inputs(device, net, batch, knn):
    """Gate (d): the EdgeConv inputs of one eval forward batch of the trained
    net, at the init net's width (C=64) and a refine stage's (C=256), through
    the kernel and through the plain version (bar 1e-3 + 2^-8 |ref|)."""
    from checkerpose_tpu_torch.models.posenet import knn_tensor
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, edgeconv_fused_plain
    from checkerpose_tpu_torch.train import steps
    init = net.init_net.graph_0
    refine = next(m for m in _edgeconvs(net) if m not in set(_edgeconvs(net.init_net)))
    convs = {init.conv.weight.shape[0]: init, refine.conv.weight.shape[0]: refine}
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, c=c: seen.setdefault(c, args))
             for c, m in convs.items()]
    k = knn_tensor(knn, len(knn), device)
    try:
        net.eval()
        steps.make_pose_forward(net, k, net.num_refine_steps)(
            {key: torch.as_tensor(batch[key], device=device) for key in ("image", "p3d_normed")})
    finally:
        for h in hooks:
            h.remove()
    res = {}
    for c, mod in convs.items():
        x, kn = seen[c]
        x = x.to(mod.dtype).contiguous()
        w1, w2m1, scale, bias, packed = mod.fused_args()
        out = edgeconv_fused(x, kn, w1, w2m1, scale, bias, mod.leaky_slope, packed=packed)
        ref = edgeconv_fused_plain(x.float(), kn, w1.float(), w2m1.float(), scale, bias,
                                   mod.leaky_slope)
        err = (out.float() - ref).abs()
        res[c] = {"shape": list(x.shape), "max_abs_err": float(err.max())}
        if not bool((err <= 1e-3 + 2 ** -8 * ref.abs()).all()):
            raise AssertionError(f"gate (d): the kernel on the trained net's C={c} EdgeConv "
                                 f"inputs {tuple(x.shape)} disagrees with the plain version: "
                                 f"max |err| {res[c]['max_abs_err']}")
    return res


def phase_workflow(device, root=None, n_test=64, n_train=128, n_scenes=2, batch=64,
                   n_vertices=2048, iters=20, test_freq=10, log_freq=5, resume_to=30,
                   graft_iters=2, cfg_overrides=None, pretrain_overrides=None, seed=0):
    """A user's single-object workflow through the CLIs' `main` functions on
    a fixture the port generates: pretrain, graft, train (and resume), test,
    merge, score; gates (a)-(e) raise."""
    import shutil
    from checkerpose_tpu_torch.cli import common, eval_bop, merge_csv, pretrain as cli_pre
    from checkerpose_tpu_torch.cli import test as cli_test, train as cli_train
    from checkerpose_tpu_torch.data.bop_io import scan_bop_object
    from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager

    on_card = device.type == "cuda"
    root = Path(root) if root is not None else ROOT / "build" / "workflow_smoke"
    shutil.rmtree(root, ignore_errors=True)
    data = str(root / "data")
    t0 = time.perf_counter()
    make_synthetic_bop(data, n_objects=1, n_scenes=n_scenes,
                       folders={"test": n_test, "train_real": n_train},
                       n_vertices=n_vertices, raw_cache=True, write_png=False, seed=seed)
    res = {"fixture": {"test_images": n_scenes * n_test, "train_images": n_scenes * n_train,
                       "vertices": n_vertices, "depth_pngs": len(list(
                           (root / "data" / "synth" / "test").glob("*/depth/*.png"))),
                       "seconds": time.perf_counter() - t0 if on_card else None}}
    if res["fixture"]["depth_pngs"] != n_scenes * n_test:
        raise AssertionError(f"fixture: {res['fixture']['depth_pngs']} depth PNGs")
    say(f"[workflow] fixture: {n_scenes} x {n_test} test images with depth PNGs + "
        f"{n_scenes} x {n_train} train_real, {n_vertices} vertices, frame cache only, "
        f"{res['fixture']['seconds']} s on the host")
    common_over = dict(bop_path=data, tensorboard_path=str(root / "tb"), log_freq=log_freq,
                       device=device.type)

    # --- (a) pretrain ------------------------------------------------------------------
    pcfg = common.resolve_cfg(str(ROOT / PRETRAIN_CFG), "obj01", dict(
        pretrain_overrides or {}, **common_over, check_point_path=str(root / "ckpt_pre"),
        total_iteration=iters, test_freq=test_freq))
    pcfg.pop("backbone_pretrain_checkpoint", None)   # overrides cannot unset a key
    run = _run_cli(device, cli_pre.main, pcfg, cli_pre, "evaluate_init", cli_pre)
    losses = _logged_losses(run["lines"])
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"gate (a): logged pretrain losses {losses}")
    bad = [ev["report"].keys() for ev in run["evals"] if set(ev["report"]) != set(INIT_EVAL_KEYS)]
    if bad or not run["evals"]:
        raise AssertionError(f"gate (a): evaluate_init reports with keys {bad}")
    pre_dir = Path(pcfg["check_point_path"])
    kept = sorted(int(d.name) for d in pre_dir.iterdir() if (d / "state.pt").is_file())
    if pre_dir != root / "ckpt_pre" / Path(PRETRAIN_CFG).stem / "obj01" or kept[-1] != iters:
        raise AssertionError(f"gate (a): checkpoints {kept} under {pre_dir}")
    pre_launches = _gate_launches(run, INIT_EDGECONVS if on_card else 0, "gate (a)")
    res["pretrain"] = {"iterations": iters, "logged_losses": losses, "checkpoints": kept,
                       "evals": len(run["evals"]),
                       "eval_batches": [e["batches"] for e in run["evals"]],
                       "eval_s": [e["seconds"] for e in run["evals"]] if on_card else None,
                       "ms_per_iter": _ms_per_iter(run, iters) if on_card else None,
                       "peak_mem_gib": run["peak_mem_gib"], "launches": pre_launches,
                       "test_acc": [e["report"]["test_acc"] for e in run["evals"]]}
    say(f"[workflow] (a) cli.pretrain.main, {iters} iterations at batch "
        f"{pcfg['batch_size']}, eval every {test_freq}: host ms an iteration without the evals "
        f"{res['pretrain']['ms_per_iter']}; evals {res['pretrain']['eval_s']} s over "
        f"{res['pretrain']['eval_batches']} batches; EdgeConv launches {pre_launches} = "
        f"{INIT_EDGECONVS} x {sum(res['pretrain']['eval_batches'])} eval batches; losses "
        f"finite ({losses[0]:.4f} -> {losses[-1]:.4f}); checkpoints {kept} under {pre_dir}; "
        f"peak {run['peak_mem_gib']} GiB")

    # --- (b) graft ---------------------------------------------------------------------
    grafted = {}

    def capture_graft(orig):
        def wrapped(cfg, state):
            state = orig(cfg, state)
            grafted.update({k: v.detach().cpu().clone() for k, v
                            in state.module.state_dict().items() if k.startswith("backbone.")})
            return state
        return wrapped

    gcfg = dict(pcfg, check_point_path=str(root / "ckpt_graft"), total_iteration=graft_iters,
                backbone_pretrain_checkpoint=str(pre_dir))
    with _wrapped(common, "maybe_graft_pretrained_backbone", capture_graft):
        grun = _run_cli(device, cli_pre.main, gcfg, cli_pre, "evaluate_init", cli_pre)
    source = CheckpointManager(str(pre_dir)).restore_raw()["model"]
    src_bb = {k: v for k, v in source.items() if k.startswith("backbone.")}
    said = [ln for ln in grun["lines"] if ln.startswith("grafted NOCS-pretrained backbone")]
    differ = [k for k, v in src_bb.items() if not torch.equal(grafted.get(k, torch.empty(0)), v)]
    if not said or not src_bb or differ or set(grafted) != set(src_bb):
        raise AssertionError(f"gate (b): graft line {said}, {len(differ)} of {len(src_bb)} "
                             f"backbone entries differ from the source")
    res["graft"] = {"line": said[0], "entries": len(src_bb),
                    "launches": _gate_launches(grun, INIT_EDGECONVS if on_card else 0,
                                               "gate (b)")}
    say(f"[workflow] (b) graft: '{said[0]}'; all {len(src_bb)} backbone entries equal the "
        f"source checkpoint's bit for bit at step 0; {graft_iters} iterations after it, "
        f"EdgeConv launches {res['graft']['launches']}")

    # --- (c) train and resume ----------------------------------------------------------
    tcfg = common.resolve_cfg(str(ROOT / EVAL_CFG), "obj01", dict(
        cfg_overrides or {}, **common_over, check_point_path=str(root / "ckpt_train"),
        Detection_reaults=f"{data}/detection_results/synth/synth_detections.json",
        init_pretrained_root=str(pre_dir.parent), total_iteration=iters, test_freq=test_freq))
    at_step0 = {}

    def capture_init(orig):
        def wrapped(net, *a, **k):
            state = orig(net, *a, **k)
            if not at_step0:
                at_step0.update({k_: v.detach().cpu().clone()
                                 for k_, v in net.init_net.state_dict().items()})
            return state
        return wrapped

    with _wrapped(cli_train, "create_pose_state", capture_init):
        trun = _run_cli(device, cli_train.main, tcfg, cli_train, "evaluate_pipeline", cli_train)
    init_src = CheckpointManager(str(pre_dir)).restore_raw()["model"]
    loaded = [k for k, v in init_src.items() if k in at_step0 and at_step0[k].shape == v.shape]
    differ = [k for k in loaded if not torch.equal(at_step0[k], init_src[k])]
    said = [ln for ln in trun["lines"] if ln.startswith("loaded pretrained init net")]
    if not said or f"(step {iters})" not in said[0] or not loaded or differ:
        raise AssertionError(f"gate (c): init line {said}; {len(differ)} of {len(loaded)} "
                             f"grafted init_net entries differ from the pretrain checkpoint")
    losses = _logged_losses(trun["lines"])
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"gate (c): logged train losses {losses}")
    n_conv = len(_edgeconvs(trun["out"].module))
    train_launches = _gate_launches(trun, EDGECONV_PER_FORWARD if on_card else 0, "gate (c)",
                                    folds_per_eval=1)
    gates = [1.0 - float(np.mean(e["report"]["bit_err"])) for e in trun["evals"]]
    eval_steps = sorted({s for s in range(test_freq, iters + 1, test_freq)} | {iters})
    ckpt = CheckpointManager(tcfg["check_point_path"])
    best = sorted(d.name for d in Path(ckpt.best_dir).iterdir())
    want_best = str(eval_steps[int(np.argmax(gates))])
    if len(gates) != len(eval_steps) or best != [want_best] \
            or ckpt.best_floor(GATE_METRIC) != max(gates):
        raise AssertionError(f"gate (c): gate scores {gates} at steps {eval_steps}, best "
                             f"checkpoint {best} (expected {want_best}), recorded "
                             f"{ckpt.best_floor(GATE_METRIC)}")
    rrun = _run_cli(device, cli_train.main, dict(tcfg, load_checkpoint=True,
                                                 total_iteration=resume_to),
                    cli_train, "evaluate_pipeline", cli_train)
    if f"resumed from step {iters}" not in rrun["lines"] or rrun["out"].step != resume_to:
        raise AssertionError(f"gate (c): the resumed run ended at step {rrun['out'].step}")
    resume_launches = _gate_launches(rrun, EDGECONV_PER_FORWARD if on_card else 0,
                                     "gate (c), resumed", folds_per_eval=1)
    r_losses = _logged_losses(rrun["lines"])
    if not np.isfinite(r_losses).all():
        raise AssertionError(f"gate (c): logged losses of the resumed run {r_losses}")
    res["train"] = {"iterations": iters, "resumed_to": resume_to, "init_entries_grafted":
                    len(loaded), "logged_losses": losses + r_losses,
                    "evals": len(trun["evals"]) + len(rrun["evals"]),
                    "eval_batches": [e["batches"] for e in trun["evals"] + rrun["evals"]],
                    "eval_s": ([e["seconds"] for e in trun["evals"] + rrun["evals"]]
                               if on_card else None),
                    "ms_per_iter": _ms_per_iter(trun, iters) if on_card else None,
                    "ms_per_iter_resumed": (_ms_per_iter(rrun, resume_to - iters)
                                            if on_card else None),
                    "peak_mem_gib": trun["peak_mem_gib"], "gate_scores": gates,
                    "best": best, "launches": train_launches,
                    "launches_resumed": resume_launches, "edgeconvs": n_conv}
    say(f"[workflow] (c) cli.train.main, {iters} iterations at batch {tcfg['batch_size']} from "
        f"'{said[0]}' ({len(loaded)} init_net entries equal the checkpoint's at step 0), eval "
        f"every {test_freq}: host ms an iteration without the evals {res['train']['ms_per_iter']}; "
        f"evals {res['train']['eval_s']} s; EdgeConv launches {train_launches} = "
        f"{EDGECONV_PER_FORWARD} x {sum(e['batches'] for e in trun['evals'])} eval batches, "
        f"each of the {n_conv} EdgeConvs folded once per eval; losses finite; best checkpoint "
        f"{best} on gate scores {gates}; peak {trun['peak_mem_gib']} GiB; resumed from step "
        f"{iters} to {resume_to}: host ms an iteration {res['train']['ms_per_iter_resumed']}, "
        f"launches {resume_launches}")

    # --- test, merge --------------------------------------------------------------------
    out_dir = root / "out"
    qcfg = dict(tcfg, ckpt_dir=tcfg["check_point_path"], eval_output_path=str(out_dir),
                test_batch_size=batch)
    reset_launch_counts()
    report = cli_test.main(qcfg)
    _sync(device)
    test_launches = dict(edgeconv_fused.launches_by_route)
    n_images = n_scenes * n_test
    forwards = -(-n_images // batch)
    want = {"tc": EDGECONV_PER_FORWARD * forwards if on_card else 0, "fma": 0}
    if test_launches != want or report["n_images"] != n_images:
        raise AssertionError(f"test CLI: launches {test_launches} (expected {want}), "
                             f"{report['n_images']} images")
    merged = merge_csv.main(["--input_dir", str(out_dir), "--output_fn", "merged.csv"])
    with open(merged) as f:
        merged_rows = len(f.readlines()) - 1

    # --- (e) score ----------------------------------------------------------------------
    samples = scan_bop_object(data, "synth", "test", 1, 0.1)
    gt_csv, pert_csv = root / "gt" / "gt.csv", root / "gt" / "perturbed.csv"
    _write_pose_csv(gt_csv, [(s.scene_id, s.im_id, s.R, s.t) for s in samples])
    rng = np.random.default_rng(seed + 7)
    _write_pose_csv(pert_csv, [(s.scene_id, s.im_id, *_perturbed(s.R, s.t, rng))
                               for s in samples])
    scores = {name: _score_csv(device, eval_bop, path, data)
              for name, path in (("gt", gt_csv), ("test_cli", merged))}
    gt, est = scores["gt"]["per_object"], scores["test_cli"]["per_object"]
    if gt["ar_mssd"] != 1.0 or gt["ar_mspd"] != 1.0 or not gt.get("ar_vsd", 0.0) > 0.95:
        raise AssertionError(f"gate (e): GT poses score {gt}")
    ars = [est[k] for k in ("ar_mssd", "ar_mspd", "ar_vsd", "ar")]
    if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in ars) \
            or est["n_estimates"] != merged_rows:
        raise AssertionError(f"gate (e): the test CLI's CSV scores {est} ({merged_rows} rows)")
    errs = _gate_bop_errors(device, {"perturbed": pert_csv, "test_cli": merged}, data)
    for sc in scores.values():
        sc["vsd_ms_per_render"] = 1e3 * sc["vsd_s"] / max(sc["vsd_renders"], 1)
        if not on_card:
            sc["errors_s"] = sc["vsd_s"] = sc["vsd_ms_per_render"] = None
    if not on_card:
        for e in errs.values():
            e["device_ms"] = None
    res["test"] = {"launches": test_launches, "images": n_images, "csv_rows": merged_rows}
    res["scores"] = scores
    res["bop_errors_vs_f64"] = errs
    say(f"[workflow] test CLI on the trained checkpoint, {n_images} images at batch {batch}: "
        f"EdgeConv launches {test_launches}; merge_csv -> {merged_rows} rows")
    for name, sc in scores.items():
        say(f"[workflow] (e) eval_bop on the {name} CSV: {sc['per_object']}; MSSD + MSPD of "
            f"{sc['pairs']} pairs x {sc['verts']} vertices x {sc['syms']} symmetries "
            f"{sc['errors_s']} s on the host clock (device synchronised); VSD {sc['vsd_s']} s "
            f"for {sc['vsd_renders']} rendered frames, {sc['vsd_ms_per_render']} ms a frame "
            f"on the host")
    for name, e in errs.items():
        say(f"[workflow] (e) batched_bop_errors on {device.type} vs float64, {e['pairs']} "
            f"pairs x {e['verts']} vertices x {e['syms']} symmetries ({name}; float64 "
            f"medians {e['median']}, diameter {e['diameter']} mm): max abs "
            f"{e['max_abs_err']}, max rel {e['max_rel_err']} (bar {BOP_ERR_ATOL:g} + "
            f"{BOP_ERR_RTOL:g} relative); {e['device_ms']} ms on the device")

    # --- (d) the kernel on the trained net's inputs, after the counted runs ------------------
    _, knn, first = _first_test_batch(qcfg, batch)
    res["kernel_inputs"] = _gate_kernel_inputs(device, rrun["out"].module, first, knn)
    say(f"[workflow] (d) tensor-core kernel vs plain version on one eval batch's EdgeConv "
        f"inputs of the trained net: {res['kernel_inputs']} (bar 1e-3 + 2^-8 |ref|)")
    res["launches_by_path"] = {"workflow_pretrain": pre_launches,
                               "workflow_graft": res["graft"]["launches"],
                               "workflow_train": train_launches,
                               "workflow_train_resumed": resume_launches,
                               "workflow_test": test_launches}
    return res


LM_PRETRAIN_CFG = "config/synth/init_gnn2_hrnetw18_npt512_synthlm.txt"
LM_TRAIN_CFG = "config/synth/hr18GNN2_res6_gnn3Skip_mlpQuery_synthlm.txt"
WOPROG = "vanilla_GNNskip_ABwoProg"
# gate (c): the per-sample path against the tensor-core kernel. The kernel
# rounds only its output to bf16; the per-sample path (the JAX package's XLA
# arithmetic) also rounds y = x W1, z = x (W2 - W1) and y_j + z_i to bf16
# before BatchNorm, so its error follows |s| (|y_j| + |z_i|), which exceeds
# |out| where the two cancel: the bar is 1e-3 + 2^-7 (|ref| + |s| max_k
# (|y_j| + |z_i|)). The share of entries over 1e-3 + 2^-7 |ref| alone is
# recorded beside it.
LM_PATH_ATOL, LM_PATH_RTOL = 1e-3, 2.0 ** -7
_MATMUL_KERNELS = ("gemm", "nvjet", "cutlass", "xmma")


def make_lm_imgn_tree(ds_dir, out_dir, obj_names, n_per_obj=16, n_backgrounds=2, seed=0,
                      size=(480, 640)):
    """An lm_imgn tree for the fixture's objects, written with the port's own
    PNG codec (no image library): per object `n_per_obj` renders of its mesh
    under random poses, each a colour PNG (the object shaded by depth on
    black), a 16-bit depth PNG in mm and a pose.txt with t in metres; and
    `n_backgrounds` colour PNGs of textured noise. Returns (imgn root,
    background dir)."""
    from checkerpose_tpu_torch.data.imageio import write_depth_png, write_rgb_png
    from checkerpose_tpu_torch.data.lm_imgn import K_LM
    from checkerpose_tpu_torch.data.ply import load_ply_mesh
    from checkerpose_tpu_torch.eval.renderer import render_depth

    rng = np.random.default_rng(seed)
    H, W = size
    out_dir = Path(out_dir)
    for obj_id, name in enumerate(obj_names, 1):
        verts, faces = load_ply_mesh(str(Path(ds_dir) / "models" / f"obj_{obj_id:06d}.ply"))
        obj_dir = out_dir / "imgn" / name
        obj_dir.mkdir(parents=True, exist_ok=True)
        base = rng.uniform(70.0, 220.0, 3)
        for i in range(n_per_obj):
            Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            R = Q * np.sign(np.linalg.det(Q))
            t = np.array([rng.uniform(-50, 50), rng.uniform(-40, 40), rng.uniform(380, 520)])
            depth = render_depth(verts, faces, R, t, K_LM, W, H)
            fg = depth > 0
            img = np.zeros((H, W, 3), np.uint8)
            near, far = depth[fg].min(), depth[fg].max()
            shade = 1.3 - 0.6 * (depth[fg] - near) / max(far - near, 1e-6)
            ys, xs = np.nonzero(fg)
            checker = 0.85 + 0.3 * (((ys // 6) + (xs // 6)) % 2)
            img[fg] = np.clip(base[None] * (shade * checker)[:, None], 0, 255).astype(np.uint8)
            write_rgb_png(str(obj_dir / f"{i:06d}-color.png"), img)
            write_depth_png(str(obj_dir / f"{i:06d}-depth.png"),
                            np.clip(np.rint(depth), 0, 65535).astype(np.uint16))
            with open(obj_dir / f"{i:06d}-pose.txt", "w") as f:
                f.write("pose\n")
                np.savetxt(f, np.hstack([R, t[:, None] / 1000.0]))
    bg_dir = out_dir / "backgrounds"
    bg_dir.mkdir(parents=True, exist_ok=True)
    for k in range(n_backgrounds):
        coarse = rng.integers(0, 256, (H // 16 + 1, W // 16 + 1, 3)).astype(np.float64)
        bg = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H // 2, :W // 2]
        bg += rng.normal(0.0, 12.0, bg.shape)
        write_rgb_png(str(bg_dir / f"bg_{k:02d}.png"), np.clip(bg, 0, 255).astype(np.uint8))
    return str(out_dir), str(bg_dir)


def _gate_lm_launches(run, per_batch, what):
    """Every eval of an LM CLI run took the per-sample path `per_batch`
    times a forward batch and launched neither kernel, and so did the whole
    run (training steps take the per-sample train path, which counts
    nothing). Returns the run's {"tc", "fma", "per_sample"}."""
    none = {"tc": 0, "fma": 0}
    for i, ev in enumerate(run["evals"]):
        if ev["launches"] != none or ev["per_sample"] != per_batch * ev["batches"]:
            raise AssertionError(f"{what}: eval {i} launched {ev['launches']} and took the "
                                 f"per-sample path {ev['per_sample']} times for "
                                 f"{ev['batches']} batches, expected {none} and "
                                 f"{per_batch} a batch")
    if run["launches"] != none:
        raise AssertionError(f"{what}: the run launched {run['launches']}, expected {none}")
    return dict(run["launches"], per_sample=run["per_sample"])


def _per_eval_fn(run, n_obj, what):
    """The run's evals (one a sweep of an object) grouped by eval_fn call:
    each group must hold objects 0..n_obj-1 in order. Returns the groups'
    seconds."""
    evs = run["evals"]
    if not evs or len(evs) % n_obj:
        raise AssertionError(f"{what}: {len(evs)} object sweeps for {n_obj} objects an eval")
    groups = [evs[i:i + n_obj] for i in range(0, len(evs), n_obj)]
    for g in groups:
        if [e["objects"] for e in g] != [[o] for o in range(n_obj)]:
            raise AssertionError(f"{what}: an eval swept objects {[e['objects'] for e in g]}")
    return [sum(e["seconds"] for e in g) for g in groups]


def _eval_lines(lines):
    """(per-object adx10 dicts, gate scores) of an LM train CLI's output."""
    import ast
    adx = [ast.literal_eval(ln.split(":", 1)[1].strip()) for ln in lines
           if ln.startswith("per-object adx10:")]
    gates = [float(w.split("=", 1)[1]) for ln in lines if ln.startswith("eval @")
             for w in ln.split() if w.startswith("gate_score=")]
    return adx, gates


def _lm_report_gate(path, n_obj, what):
    """Gate (e) on report_lm_*.json: per_object for n_obj objects and the
    average; rates and seg IoU in [0, 1], bit errors in [0, 1], the rest
    finite except where the harness defines the value otherwise: auc_posecnn
    is NaN when no estimate lies within 0.1 m, mean_te_mm inf when no pose
    was solved (both the reference's definitions). Returns the report."""
    with open(path) as f:
        rep = json.load(f)
    per, avg = rep.get("per_object", {}), rep.get("average", {})
    if len(per) != n_obj or set(avg) != set(next(iter(per.values()))):
        raise AssertionError(f"{what}: per_object {sorted(per)}, average keys {sorted(avg)}")
    for name, row in [*per.items(), ("average", avg)]:
        for k, v in row.items():
            if k in EVAL_RATE_KEYS or k == "seg_iou":
                ok = 0.0 <= v <= 1.0
            elif k == "auc_posecnn":
                ok = np.isnan(v) or 0.0 <= v <= 1.0
            elif k == "mean_te_mm":
                ok = v == np.inf or np.isfinite(v)
            else:
                ok = bool(np.isfinite(v))
            if not ok:
                raise AssertionError(f"{what}: {name} {k} = {v}")
    be = np.asarray(rep["bit_err"])
    if len(rep["bit_err_per_object"]) != n_obj or not ((be >= 0) & (be <= 1)).all():
        raise AssertionError(f"{what}: bit_err {rep['bit_err']}")
    return rep


def _split_ms(kernels):
    """(total ms, the matmuls' ms, the rest) of `_device_kernels`' list."""
    if kernels is None:
        return None, None, None
    mm = sum(ms for name, ms in kernels if any(t in name.lower() for t in _MATMUL_KERNELS))
    total = sum(ms for _, ms in kernels)
    return total, mm, total - mm


def _edgeconv_inputs_of(net, fn):
    """Run fn() once with a forward pre-hook on every EdgeConv of `net`:
    [(module, x, knn)] in call order."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, *args)))
             for m in _edgeconvs(net)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _lm_edgeconv_profile(device, net, knn_stack, step, state, batch, gen):
    """On one batch of mixed objects, device ms from torch.profiler: (1) one
    warm LM train step, and its per-sample EdgeConvs alone (forward +
    backward on the inputs they got in that step, on copies of the
    modules); (2) one LM eval forward, and its per-sample EdgeConvs alone;
    each set of EdgeConv calls profiled in one window and split into the
    projections' matmuls and the rest (gather, BatchNorm, max, and in the
    step the scatter-add). By CUDA events
    (mean of 5 after 2 warm calls): (3) the same eval EdgeConvs, and the same
    inputs through the tensor-core kernel on a static graph (knn_stack[0]),
    the single-object eval forward's EdgeConvs (on the H100 torch.profiler
    has returned no device event for some short windows); a time the
    profiler did not record is None."""
    import copy
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused
    from checkerpose_tpu_torch.train import steps

    net.train()
    step(state, batch, gen)                              # warm
    _sync(device)
    step_ms = _split_ms(_device_kernels(lambda: step(state, batch, gen), device))[0]
    captured = _edgeconv_inputs_of(net, lambda: step(state, batch, gen))
    train_calls = []
    for mod, x, kn in captured:
        m2 = copy.deepcopy(mod).train()
        xd = x.detach().requires_grad_(True)
        g = torch.randn(x.shape[0], x.shape[1], m2.conv.weight.shape[0], device=device,
                        dtype=m2.dtype)

        def fwd_bwd(m2=m2, xd=xd, kn=kn, g=g):
            m2(xd, kn).backward(g)
        fwd_bwd()                                        # warm
        train_calls.append(fwd_bwd)
    n_conv = len(captured)
    train_ec = _split_ms(_device_kernels(lambda: [f() for f in train_calls], device))

    net.eval()
    fwd = steps.make_pose_forward(net, knn_stack, net.num_refine_steps)
    fwd(batch)
    _sync(device)
    fwd_ms = _split_ms(_device_kernels(lambda: fwd(batch), device))[0]
    captured = _edgeconv_inputs_of(net, lambda: fwd(batch))
    static = knn_stack[0].contiguous()
    eval_calls, tc_calls = [], []
    for mod, x, kn in captured:
        args = mod.fused_args()
        xs = x.to(mod.dtype).contiguous()
        eval_calls.append(lambda m=mod, x=x, kn=kn: m(x, kn))
        tc_calls.append(lambda xs=xs, args=args, m=mod: edgeconv_fused(
            xs, static, *args[:4], m.leaky_slope, packed=args[4]))
    with torch.no_grad():
        eval_ec = _split_ms(_device_kernels(lambda: [c() for c in eval_calls], device))
        eval_event = time_ms(lambda: [c() for c in eval_calls], device, iters=5)
        tc_event = time_ms(lambda: [c() for c in tc_calls], device, iters=5)

    res = {"edgeconvs": n_conv, "train_step_device_ms": step_ms,
           "train_edgeconv_ms": train_ec[0], "train_edgeconv_matmul_ms": train_ec[1],
           "train_edgeconv_rest_ms": train_ec[2], "eval_forward_device_ms": fwd_ms,
           "eval_edgeconv_ms": eval_ec[0], "eval_edgeconv_matmul_ms": eval_ec[1],
           "eval_edgeconv_rest_ms": eval_ec[2], "eval_edgeconv_event_ms": eval_event,
           "eval_tc_static_event_ms": tc_event, "batch": int(batch["image"].shape[0])}
    if step_ms and train_ec[0] is not None:
        res["train_edgeconv_share"] = train_ec[0] / step_ms
    if fwd_ms and eval_ec[0] is not None:
        res["eval_edgeconv_share"] = eval_ec[0] / fwd_ms
    return res


def _gate_lm_paths(device, net, knn_stack, batch):
    """Gate (c): the EdgeConv inputs of one eval batch with mixed obj_idx at
    the init net's width (C=64) and a refine stage's (C=256), through the
    per-sample eval path with knn_stack[obj_idx] and through the tensor-core
    kernel launched once per object on its rows with the static
    knn_stack[o]; ref the per-sample path, bar as LM_PATH_* says."""
    from checkerpose_tpu_torch.ops.edgeconv import (edgeconv_eval_per_sample, edgeconv_fused,
                                                    gather_neighbors)
    from checkerpose_tpu_torch.train import steps
    net.eval()
    init = net.init_net.graph_0
    refine = next(m for m in _edgeconvs(net) if m not in set(_edgeconvs(net.init_net)))
    wanted = {init, refine}
    fwd = steps.make_pose_forward(net, knn_stack, net.num_refine_steps)
    seen = {mod: (x, kn) for mod, x, kn in _edgeconv_inputs_of(net, lambda: fwd(batch))
            if mod in wanted}
    obj_idx = batch["obj_idx"].long()
    res = {"objects": sorted(torch.unique(obj_idx).tolist())}
    if len(res["objects"]) < 2:
        raise AssertionError(f"gate (c): the batch holds objects {res['objects']}")
    with torch.no_grad():
        for mod in (init, refine):
            x, kn = seen[mod]
            x = x.to(mod.dtype).contiguous()
            if not torch.equal(kn, knn_stack[obj_idx]):
                raise AssertionError("gate (c): the forward's graph is not knn_stack[obj_idx]")
            w1, w2m1 = mod.split_weights()
            ref = edgeconv_eval_per_sample(x, kn, w1, w2m1, mod.bn, mod.leaky_slope).float()
            fw1, fw2m1, scale, bias, packed = mod.fused_args()
            out = torch.empty_like(ref)
            for o in res["objects"]:
                rows = (obj_idx == o).nonzero().flatten()
                out[rows] = edgeconv_fused(x[rows].contiguous(), knn_stack[o].contiguous(), fw1,
                                           fw2m1, scale, bias, mod.leaky_slope,
                                           packed=packed).float()
            xf = x.float()
            y, z = xf @ w1.float(), xf @ w2m1.float()
            terms = (gather_neighbors(y, kn).abs() + z.abs()[:, :, None]).amax(2)
            err = (out - ref).abs()
            bar = LM_PATH_ATOL + LM_PATH_RTOL * (ref.abs() + scale.abs() * terms)
            c = x.shape[-1]
            res[c] = {"shape": list(x.shape), "max_abs_err": float(err.max()),
                      "max_err_over_bar": float((err / bar).max()),
                      "share_over_out_only_bar": float(
                          (err > LM_PATH_ATOL + LM_PATH_RTOL * ref.abs()).float().mean())}
            if not bool((err <= bar).all()):
                raise AssertionError(f"gate (c): the per-sample path and the kernel disagree "
                                     f"at C={c}: {res[c]}")
    return res


def phase_lm(device, root=None, n_objects=4, n_test=32, n_train=128, n_scenes=2,
             n_imgn=16, batch=64, n_vertices=2048, iters=20, test_freq=10, log_freq=5,
             resume_to=30, woprog_iters=4, cfg_overrides=None, pretrain_overrides=None,
             ref_batch=2, single_object_train=None, seed=0):
    """The LM multi-object workflow through the CLIs' `main` functions on a
    fixture the port generates: pretrain_lm, train_lm (and resume),
    test_lm hard and adaptive, the woProg ablation; gates (a)-(e) raise.
    `single_object_train`: phase workflow's train CLI result, for the ratio
    of the two CLIs' iteration times."""
    import shutil
    from checkerpose_tpu_torch.cli import common, pretrain_lm as cli_pre
    from checkerpose_tpu_torch.cli import test_lm as cli_test, train_lm as cli_train
    from checkerpose_tpu_torch.data.bop_io import scan_bop_object
    from checkerpose_tpu_torch.data.dataset import CropDataset
    from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
    from checkerpose_tpu_torch.eval.harness import DEFAULT_TAU_GRID
    from checkerpose_tpu_torch.models.posenet import knn_tensor
    from checkerpose_tpu_torch.train import steps
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager

    on_card = device.type == "cuda"
    root = Path(root) if root is not None else ROOT / "build" / "lm_smoke"
    shutil.rmtree(root, ignore_errors=True)
    data = str(root / "data")
    t0 = time.perf_counter()
    ds_dir = make_synthetic_bop(data, n_objects=n_objects, n_scenes=n_scenes,
                                folders={"test": n_test, "train_real": n_train},
                                n_vertices=n_vertices, raw_cache=True, write_png=False, seed=seed)
    names = [f"obj{i:02d}" for i in range(1, n_objects + 1)]      # the synth dataset's
    imgn_root, bg_root = make_lm_imgn_tree(ds_dir, root / "lm_imgn", names, n_imgn, seed=seed)
    res = {"fixture": {"objects": n_objects, "test_images": n_scenes * n_test,
                       "train_real_images": n_scenes * n_train, "imgn_renders": n_objects * n_imgn,
                       "backgrounds": 2, "vertices": n_vertices,
                       "seconds": time.perf_counter() - t0 if on_card else None}}
    say(f"[lm] fixture: {n_objects} objects of {n_vertices} vertices, {n_scenes} x {n_test} "
        f"test + {n_scenes} x {n_train} train_real images (frame cache only), "
        f"{n_objects} x {n_imgn} lm_imgn renders and 2 backgrounds as PNGs by the port's own "
        f"codec, {res['fixture']['seconds']} s on the host")
    over = dict(bop_path=data, tensorboard_path=str(root / "tb"), log_freq=log_freq,
                device=device.type, obj_names=",".join(names), training_data_folder_2="lm_imgn",
                lm_imgn_root=imgn_root, background_root=bg_root, change_bg_prob=0.5)

    # --- (a) pretrain_lm -------------------------------------------------------------------
    pcfg = common.resolve_cfg_lm(str(ROOT / LM_PRETRAIN_CFG), dict(
        pretrain_overrides or {}, **over, check_point_path=str(root / "ckpt_pre"),
        total_iteration=iters, test_freq=test_freq))
    pcfg.pop("backbone_pretrain_checkpoint", None)   # overrides cannot unset a key
    run = _run_cli(device, cli_pre.main, pcfg, cli_pre, "evaluate_init", cli_pre)
    losses = _logged_losses(run["lines"])
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"gate (a): logged pretrain_lm losses {losses}")
    pre_dir = Path(pcfg["check_point_path"])
    kept = sorted(int(d.name) for d in pre_dir.iterdir() if (d / "state.pt").is_file())
    want_kept = sorted({*range(test_freq, iters + 1, test_freq), iters})
    if pre_dir != root / "ckpt_pre" / Path(LM_PRETRAIN_CFG).stem / "lm13" or kept != want_kept:
        raise AssertionError(f"gate (a): checkpoints {kept} under {pre_dir}")
    pre_eval_s = _per_eval_fn(run, n_objects, "gate (a)")
    pre_convs = len(_edgeconvs(run["out"].module))
    if pretrain_overrides is None and pre_convs != INIT_EDGECONVS:
        raise AssertionError(f"gate (a): the init net has {pre_convs} EdgeConvs")
    pre_launches = _gate_lm_launches(run, pre_convs, "gate (a)")
    res["pretrain_lm"] = {
        "iterations": iters, "logged_losses": losses, "checkpoints": kept,
        "evals": len(pre_eval_s), "eval_fn_s": pre_eval_s if on_card else None,
        "ms_per_iter": _ms_per_iter(run, iters) if on_card else None,
        "peak_mem_gib": run["peak_mem_gib"], "launches": pre_launches,
        "mixed_batches": sum(n >= 2 for n in run["step_objects"])}
    say(f"[lm] (a) cli.pretrain_lm.main, {iters} iterations at batch {pcfg['batch_size']} "
        f"over {n_objects} objects, eval every {test_freq}: host ms an iteration without the "
        f"evals {res['pretrain_lm']['ms_per_iter']}; eval_fn {res['pretrain_lm']['eval_fn_s']} s "
        f"({n_objects} object sweeps each); launches {pre_launches} (per-sample path "
        f"{pre_convs} a forward batch); losses finite ({losses[0]:.4f} -> "
        f"{losses[-1]:.4f}); checkpoints {kept} under {pre_dir}; peak {run['peak_mem_gib']} GiB")

    # --- (b) train_lm and resume -----------------------------------------------------------
    tcfg = common.resolve_cfg_lm(str(ROOT / LM_TRAIN_CFG), dict(
        cfg_overrides or {}, **over, check_point_path=str(root / "ckpt_train"),
        Detection_reaults=f"{data}/detection_results/synth/synth_detections.json",
        init_pretrained_root=str(pre_dir.parent), total_iteration=iters, test_freq=test_freq))
    at_step0, swaps = {}, {"syn": 0, "real": 0}

    def capture_init(orig):
        def wrapped(net, *a, **k):
            state = orig(net, *a, **k)
            if not at_step0:
                at_step0.update({k_: v.detach().cpu().clone()
                                 for k_, v in net.init_net.state_dict().items()})
            return state
        return wrapped

    def count_swaps(orig):
        def wrapped(ds, *a):
            swaps["syn" if ds.samples[0].img_type == "syn" else "real"] += 1
            return orig(ds, *a)
        return wrapped

    with _wrapped(cli_train, "create_pose_state", capture_init), \
            _wrapped(CropDataset, "_replace_bg", count_swaps):
        trun = _run_cli(device, cli_train.main, tcfg, cli_train, "evaluate_pipeline", cli_train)
    init_src = CheckpointManager(str(pre_dir)).restore_raw()["model"]
    loaded = [k for k, v in init_src.items() if k in at_step0 and at_step0[k].shape == v.shape]
    differ = [k for k in loaded if not torch.equal(at_step0[k], init_src[k])]
    said = [ln for ln in trun["lines"] if ln.startswith("loaded pretrained init net")]
    if not said or f"(step {iters})" not in said[0] or not loaded or differ:
        raise AssertionError(f"gate (b): init line {said}; {len(differ)} of {len(loaded)} "
                             f"init_net entries differ from the pretrain checkpoint")
    losses = _logged_losses(trun["lines"])
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"gate (b): logged train_lm losses {losses}")
    adx, gates = _eval_lines(trun["lines"])
    n_evals = len(want_kept)
    if len(adx) != n_evals or any(sorted(a) != names for a in adx) \
            or len(gates) != n_evals or not all(0.0 <= g <= 1.0 for g in gates):
        raise AssertionError(f"gate (b): per-object adx10 {adx}, gate scores {gates}")
    train_eval_s = _per_eval_fn(trun, n_objects, "gate (b)")
    n_conv = len(_edgeconvs(trun["out"].module))
    if cfg_overrides is None and n_conv != EDGECONV_PER_FORWARD:
        raise AssertionError(f"gate (b): the network has {n_conv} EdgeConvs")
    train_launches = _gate_lm_launches(trun, n_conv, "gate (b)")
    if max(trun["step_objects"], default=0) < 2:
        raise AssertionError(f"gate (b): no training batch mixed two objects "
                             f"({trun['step_objects']})")
    if swaps["syn"] == 0:
        raise AssertionError(f"gate (b): the background swap ran {swaps} times")
    rrun = _run_cli(device, cli_train.main, dict(tcfg, load_checkpoint=True,
                                                 total_iteration=resume_to),
                    cli_train, "evaluate_pipeline", cli_train)
    if f"resumed from step {iters}" not in rrun["lines"] or rrun["out"].step != resume_to:
        raise AssertionError(f"gate (b): the resumed run ended at step {rrun['out'].step}")
    resume_launches = _gate_lm_launches(rrun, n_conv, "gate (b), resumed")
    r_losses = _logged_losses(rrun["lines"])
    if not np.isfinite(r_losses).all():
        raise AssertionError(f"gate (b): logged losses of the resumed run {r_losses}")
    ms = _ms_per_iter(trun, iters) if on_card else None
    so = (single_object_train or {}).get("ms_per_iter") or {}
    ratio = (ms["median_later"] / so["median_later"]
             if ms and so.get("median_later") else None)
    res["train_lm"] = {
        "iterations": iters, "resumed_to": resume_to, "init_entries_grafted": len(loaded),
        "logged_losses": losses + r_losses, "per_object_adx10": adx, "gate_scores": gates,
        "eval_fn_s": (train_eval_s + _per_eval_fn(rrun, n_objects, "gate (b), resumed")
                      if on_card else None),
        "ms_per_iter": ms,
        "ms_per_iter_resumed": _ms_per_iter(rrun, resume_to - iters) if on_card else None,
        "single_object_train_median_ms": so.get("median_later"),
        "median_ratio_to_single_object": ratio,
        "peak_mem_gib": trun["peak_mem_gib"], "launches": train_launches,
        "launches_resumed": resume_launches, "most_objects_in_a_batch": max(trun["step_objects"]),
        "background_swaps": swaps}
    say(f"[lm] (b) cli.train_lm.main, {iters} iterations at batch {tcfg['batch_size']} from "
        f"'{said[0]}' ({len(loaded)} init_net entries equal the checkpoint's at step 0), eval "
        f"every {test_freq}: host ms an iteration without the evals {ms}; single-object train "
        f"CLI median {so.get('median_later')} ms, ratio {ratio}; eval_fn "
        f"{res['train_lm']['eval_fn_s']} s; launches {train_launches} (per-sample path "
        f"{n_conv} a forward batch); per-object adx10 {adx}; gate scores "
        f"{gates}; up to {max(trun['step_objects'])} objects in a training batch; background "
        f"swaps {swaps}; peak {trun['peak_mem_gib']} GiB; resumed from step {iters} to "
        f"{resume_to}: host ms an iteration {res['train_lm']['ms_per_iter_resumed']}, "
        f"launches {resume_launches}")

    # --- (e) test_lm, hard and adaptive --------------------------------------------------------
    out_dir = root / "out"
    qcfg = dict(tcfg, ckpt_dir=tcfg["check_point_path"], eval_output_path=str(out_dir),
                test_batch_size=batch, adx_type="visib")
    report_path = out_dir / f"report_lm_{tcfg['config_file_name']}.json"
    tests = {}
    for mode, extra in (("hard", dict(decode_mode="hard")),
                        ("adaptive", dict(decode_mode="adaptive", decode_tau_auto=True))):
        qrun = _run_cli(device, cli_test.main, dict(qcfg, **extra), cli_test,
                        "evaluate_pipeline", None)
        rep = _lm_report_gate(report_path, n_objects, f"gate (e), {mode}")
        if len(qrun["evals"]) != n_objects or [e["objects"] for e in qrun["evals"]] \
                != [[o] for o in range(n_objects)]:
            raise AssertionError(f"gate (e), {mode}: object sweeps "
                                 f"{[e['objects'] for e in qrun['evals']]}")
        if mode == "adaptive" and (rep.get("decode_conf_tau") not in DEFAULT_TAU_GRID
                                   or "tau_sweep" not in rep):
            raise AssertionError(f"gate (e): adaptive tau {rep.get('decode_conf_tau')}")
        tests[mode] = {"launches": _gate_lm_launches(qrun, n_conv, f"gate (e), {mode}"),
                       "s_per_object": ([e["seconds"] for e in qrun["evals"]]
                                        if on_card else None),
                       "average": rep["average"], "decode_conf_tau": rep.get("decode_conf_tau"),
                       "bit_err": rep["bit_err"]}
        say(f"[lm] (e) cli.test_lm.main, {mode}, adx_type visib: {n_objects} objects, s per "
            f"object {tests[mode]['s_per_object']}; launches {tests[mode]['launches']}; "
            f"tau {rep.get('decode_conf_tau')}; average {rep['average']}")
    res["test_lm"] = tests

    # --- (c) the per-sample path against the kernel ------------------------------------------
    net = rrun["out"].module
    p3d_table, p3dn_stack, knn_np = common.load_keypoints_lm(tcfg)
    knn_stack = knn_tensor(knn_np, knn_np.shape[1], device)
    test_samples = [s for o in sorted(tcfg["obj_ids"])
                    for s in scan_bop_object(data, "synth", "test", o, 0.1)]
    mix_ds = CropDataset(test_samples, p3d_table, is_train=False, crop_size_gt=64,
                         frame_cache=common._frame_cache(tcfg))
    order = np.random.default_rng(seed).permutation(len(mix_ds))[:batch]
    mixed = common.attach_p3d(_stack_items([mix_ds[int(i)] for i in order]), p3dn_stack)
    mixed_t = _on(device, mixed)
    res["paths"] = _gate_lm_paths(device, net, knn_stack, mixed_t)
    say(f"[lm] (c) per-sample eval path vs the tensor-core kernel launched per object on a "
        f"static graph, one eval batch of the trained net with objects "
        f"{res['paths']['objects']}: "
        + "; ".join(f"C={c} {v['shape']} max |err| {v['max_abs_err']:.4g}, at most "
                    f"{v['max_err_over_bar']:.3f} of the bar, {v['share_over_out_only_bar']:.4f} "
                    f"of entries over 1e-3 + 2^-7 |ref| alone"
                    for c, v in res["paths"].items() if c != "objects")
        + f" (bar {LM_PATH_ATOL:g} + 2^-7 (|ref| + |s| max_k (|y_j| + |z_i|)))")

    # --- the per-sample EdgeConv's device time ------------------------------------------------
    opts = cli_train.step_options(tcfg, resume_to, net.num_refine_steps)[net.num_refine_steps]
    step = steps.make_train_step(net, knn_stack, net.num_refine_steps, **opts)
    gen = torch.Generator(device=device).manual_seed(seed)
    res["edgeconv_profile"] = _lm_edgeconv_profile(device, net, knn_stack, step, rrun["out"],
                                                   mixed_t, gen)
    p = res["edgeconv_profile"]
    say(f"[lm] per-sample EdgeConv, torch.profiler device ms: one warm train step "
        f"{p['train_step_device_ms']}, its {p['edgeconvs']} EdgeConvs forward + backward "
        f"{p['train_edgeconv_ms']} (matmuls {p['train_edgeconv_matmul_ms']}, gather + BN + max "
        f"+ scatter-add {p['train_edgeconv_rest_ms']}), share {p.get('train_edgeconv_share')}; "
        f"one eval forward batch of {p['batch']} {p['eval_forward_device_ms']}, its "
        f"EdgeConvs {p['eval_edgeconv_ms']} (matmuls {p['eval_edgeconv_matmul_ms']}, rest "
        f"{p['eval_edgeconv_rest_ms']}), share {p.get('eval_edgeconv_share')}; CUDA events: "
        f"the eval EdgeConvs {p['eval_edgeconv_event_ms']}, the same {p['edgeconvs']} inputs "
        f"through the tensor-core kernel on a static graph {p['eval_tc_static_event_ms']}")

    # --- (e) woProg ------------------------------------------------------------------------
    wcfg = dict(tcfg, network_type=WOPROG, check_point_path=str(root / "ckpt_woprog"),
                total_iteration=woprog_iters, test_freq=woprog_iters, log_freq=1)
    ids = []

    def record_ids(orig):
        def wrapped(net_, knn, stage):
            fwd = orig(net_, knn, stage)

            def recorded(b):
                out = fwd(b)
                ids.append((int(out["x_id"].max()), int(out["y_id"].max()),
                            tuple(out["x_logits"].shape)))
                return out
            return recorded
        return wrapped

    wrun = _run_cli(device, cli_train.main, wcfg, cli_train, "evaluate_pipeline", cli_train)
    w_losses = _logged_losses(wrun["lines"])
    if not w_losses or not np.isfinite(w_losses).all() \
            or type(wrun["out"].module).__name__ != "PoseNetWoProg":
        raise AssertionError(f"gate (e), woProg: {type(wrun['out'].module).__name__}, "
                             f"losses {w_losses}")
    w_conv = len(_edgeconvs(wrun["out"].module))
    w_train = _gate_lm_launches(wrun, w_conv, "gate (e), woProg train")
    wq = dict(wcfg, ckpt_dir=wcfg["check_point_path"], eval_output_path=str(root / "out_wo"),
              test_batch_size=batch)
    with _wrapped(steps, "make_pose_forward", record_ids):
        wqrun = _run_cli(device, cli_test.main, wq, cli_test, "evaluate_pipeline", None)
    w_path = root / "out_wo" / f"report_lm_{tcfg['config_file_name']}.json"
    w_rep = _lm_report_gate(w_path, n_objects, "gate (e), woProg")
    npoint = knn_np.shape[1]
    if not ids or any(x >= 64 or y >= 64 or shape[1:] != (npoint, 6) for x, y, shape in ids):
        raise AssertionError(f"gate (e), woProg: ids and logit shapes {ids}")
    res["woprog"] = {"iterations": woprog_iters, "logged_losses": w_losses,
                     "launches_train": w_train,
                     "launches_test": _gate_lm_launches(wqrun, w_conv,
                                                        "gate (e), woProg test"),
                     "max_ids": [max(i[0] for i in ids), max(i[1] for i in ids)],
                     "average": w_rep["average"]}
    say(f"[lm] (e) woProg: cli.train_lm.main {woprog_iters} iterations (losses "
        f"{w_losses}), cli.test_lm.main: x_id / y_id max {res['woprog']['max_ids']} (< 64 at "
        f"stage 3), x_logits (B, {npoint}, 6); launches {res['woprog']['launches_test']}")

    # --- (d) card against CPU, a multi-object train step ---------------------------------------
    two = [next(i for i, sm in enumerate(mix_ds.samples) if sm.obj_id == o)
           for o in sorted(tcfg["obj_ids"])[:ref_batch]]
    small = _stack_items([mix_ds[int(i)] for i in two])
    small = common.attach_p3d({k: small[k] for k in ("image", "proj_xy", "bbox", "mask_visib",
                                                     "mask_full", "obj_idx")}, p3dn_stack)
    net_cfg = dict(npoint=npoint, backbone_name=tcfg["init_network_backbone_name"],
                   res_log2=int(tcfg["network_res_log2"]),
                   num_graph_module=int(tcfg["network_num_graph_module"]),
                   init_num_graph_module=int(tcfg.get("init_network_num_graph_module", 2)),
                   local_k=int(tcfg.get("network_local_k", 2)))
    res["card_vs_cpu"] = _gate_card_vs_cpu(device, net_cfg, knn_np, small, seed, tag="lm",
                                           gate="(d)")
    res["launches_by_path"] = {"lm_pretrain": pre_launches, "lm_train": train_launches,
                               "lm_train_resumed": resume_launches,
                               "lm_test_hard": tests["hard"]["launches"],
                               "lm_test_adaptive": tests["adaptive"]["launches"],
                               "lm_woprog_train": w_train,
                               "lm_woprog_test": res["woprog"]["launches_test"]}
    return res


NOCS_CFG = "config/synth/nocs_backbone_synth.txt"
OTHER_BACKBONES = ("hrnet_w30", "convnext_tiny", "convnext_small", "convnext_base", "darknet53")
TIMM_BACKBONES = ("resnet34", "hrnet_w18")
# gate (e): on-card rasterizer against the host z-buffer, JAX's bars
# (tests/test_raster.py): coverage differing on < 2% of pixels, 99th
# percentile of the relative z error < 5e-3; NOCS labels against float64
RASTER_COVER_TOL, RASTER_Z_Q99_TOL, NOCS_LABEL_TOL = 0.02, 5e-3, 1e-4


def _nocs_labels_f64(depth, mask, bbox, K, R, t, diameter):
    """`train/steps.py::nocs_labels` in float64 numpy, sample by sample."""
    S = depth.shape[1]
    g = np.arange(S, dtype=np.float64) + 0.5
    out = []
    for z, bb, Ki, Ri, ti in zip(depth, bbox, K, R, t):
        uu = np.broadcast_to((bb[2] / S * g + bb[0])[None, :], (S, S))
        vv = np.broadcast_to((bb[3] / S * g + bb[1])[:, None], (S, S))
        P = np.stack([(uu - Ki[0, 2]) * z / Ki[0, 0], (vv - Ki[1, 2]) * z / Ki[1, 1], z], -1)
        out.append(np.clip((P - ti) @ Ri / diameter + 0.5, 0.0, 1.0))
    return np.stack(out), ((depth > 0) & (mask > 0.5)).astype(np.float64)


def _gate_raster_and_labels(device, mesh, batch, diameter, n_host):
    """Gate (e): one training batch's depth crops rendered on the device
    against the host z-buffer (eval/renderer.py::render_depth at the crop
    intrinsics) on its first `n_host` samples, and its NOCS labels against
    float64 numpy; the rasterizer's device ms (CUDA events)."""
    from checkerpose_tpu_torch.eval.renderer import render_depth
    from checkerpose_tpu_torch.ops.raster import face_chunks, render_depth_crops
    from checkerpose_tpu_torch.train.steps import nocs_labels

    verts, faces = mesh
    b = {k: torch.as_tensor(batch[k], device=device)
         for k in ("R", "t", "cam_K", "bbox", "mask_visib")}
    S = b["mask_visib"].shape[1]
    vt = torch.as_tensor(verts, dtype=torch.float32, device=device)
    chunks = face_chunks(faces, device)

    def render():
        return render_depth_crops(vt, chunks, b["R"], b["t"], b["cam_K"], b["bbox"], S)

    depth = render()
    raster_ms = time_ms(render, device, iters=3, warm=1)
    got = depth.cpu().numpy()
    worst = {"coverage_xor": 0.0, "z_rel_q99": 0.0, "covered_min": None}
    for i in range(min(n_host, len(got))):
        bb, Kf = batch["bbox"][i].astype(np.float64), batch["cam_K"][i].astype(np.float64)
        Kc = np.array([[Kf[0, 0] * S / bb[2], 0, (Kf[0, 2] - bb[0]) * S / bb[2]],
                       [0, Kf[1, 1] * S / bb[3], (Kf[1, 2] - bb[1]) * S / bb[3]], [0, 0, 1.0]])
        want = render_depth(verts, faces, batch["R"][i], batch["t"][i], Kc, S, S)
        hit_g, hit_w = got[i] > 0, want > 0
        both = hit_g & hit_w
        if not both.any():
            raise AssertionError(f"gate (e): sample {i} renders nothing on one side "
                                 f"({hit_g.sum()} / {hit_w.sum()} pixels)")
        err = np.abs(got[i][both] - want[both]) / want[both]
        worst["coverage_xor"] = max(worst["coverage_xor"], float((hit_g ^ hit_w).mean()))
        worst["z_rel_q99"] = max(worst["z_rel_q99"], float(np.quantile(err, 0.99)))
        worst["covered_min"] = min(worst["covered_min"] or S * S, int(both.sum()))
    if worst["coverage_xor"] >= RASTER_COVER_TOL or worst["z_rel_q99"] >= RASTER_Z_Q99_TOL:
        raise AssertionError(f"gate (e): rasterizer against the host z-buffer {worst}")
    nocs, valid = nocs_labels(depth, b["mask_visib"], b["bbox"], b["cam_K"], b["R"], b["t"],
                              diameter)
    ref, ref_valid = _nocs_labels_f64(got.astype(np.float64), batch["mask_visib"],
                                      *(batch[k].astype(np.float64)
                                        for k in ("bbox", "cam_K", "R", "t")), diameter)
    label_err = float(np.abs(nocs.cpu().numpy() - ref).max())
    if not np.array_equal(valid.cpu().numpy(), ref_valid) or label_err > NOCS_LABEL_TOL:
        raise AssertionError(f"gate (e): NOCS labels against float64: max err {label_err}")
    return {"compared_samples": min(n_host, len(got)), **worst,
            "label_max_abs_err": label_err, "valid_cells": int(ref_valid.sum()),
            "raster_device_ms_per_batch": raster_ms, "batch": len(got), "S": S,
            "faces": len(faces)}


def _fixture(root, data_root, n_test, n_train, n_scenes, n_vertices, seed):
    """The single-object fixture of phase workflow: its directory when it is
    there, else one made by the same generator under `root`."""
    from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
    if data_root is not None and (Path(data_root) / "synth" / "models").is_dir():
        return str(data_root), False
    data = str(root / "data")
    make_synthetic_bop(data, n_objects=1, n_scenes=n_scenes,
                       folders={"test": n_test, "train_real": n_train},
                       n_vertices=n_vertices, raw_cache=True, write_png=False, seed=seed)
    return data, True


def phase_backbones(device, batch=512, npoint=512, serving_backbone="resnet34", iters=5,
                    other_backbones=OTHER_BACKBONES, other_batch=64, ref_batch=2,
                    timm_backbones=TIMM_BACKBONES, timm_batch=8, root=None, data_root=None,
                    n_test=64, n_train=128, n_scenes=2, n_vertices=2048, nocs_iters=20,
                    graft_iters=2, eval_batch=64, n_host_renders=16, nocs_overrides=None,
                    pretrain_overrides=None, eval_overrides=None, hrnet_w18_crops_per_s=None,
                    seed=0):
    """The other backbones, the timm import and NOCS pretraining; gates
    (a)-(f) raise. (a) the slice's main path: ServingPipeline on
    `serving_backbone` at the flagship PoseNet width, batch `batch`; (b)
    each other backbone at batch `other_batch`; (c) each backbone on the
    card against the CPU in f32; (d) hand-written timm state_dicts through
    the converters into a flagship PoseNet's init net; (e) cli.pretrain_backbone
    at NOCS_CFG's width with the rasterizer and labels against the host, then
    the pretrain CLI grafting its checkpoint; (f) the test CLI on a
    `serving_backbone` PoseNet."""
    import shutil
    from checkerpose_tpu_torch.cli import common, pretrain as cli_pre, test as cli_test
    from checkerpose_tpu_torch.cli import pretrain_backbone as cli_nocs
    from checkerpose_tpu_torch.cli.train import build_pose_net
    from checkerpose_tpu_torch.data.bop_io import model_ply_path, scan_bop_object
    from checkerpose_tpu_torch.data.dataset import CropDataset
    from checkerpose_tpu_torch.data.ply import load_ply_mesh
    from checkerpose_tpu_torch.models import convert
    from checkerpose_tpu_torch.models.posenet import knn_tensor, make_posenet
    from checkerpose_tpu_torch.ops.crop import normalize_image
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
    from checkerpose_tpu_torch.ops.geometry import pc_normalize
    from checkerpose_tpu_torch.ops.knn import knn_index
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
    from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer

    on_card = device.type == "cuda"
    per_fwd = EDGECONV_PER_FORWARD if on_card else 0
    t_phase = time.perf_counter()
    res, paths = {}, {}

    # --- (a) the main path: serving on resnet34 at batch 512 ---------------------------
    a = phase_serving(device, batch=batch, npoint=npoint, backbone=serving_backbone,
                      iters=iters, seed=seed)
    a["vs_hrnet_w18"] = (a["crops_per_s"] / hrnet_w18_crops_per_s
                         if on_card and hrnet_w18_crops_per_s else None)
    res["serving"] = {serving_backbone: a}
    paths[f"backbones_serving_{serving_backbone}"] = a["edgeconv_launches_by_route"]
    say(f"[backbones] (a) {serving_backbone} serving at batch {batch}: {a['crops_per_s']} "
        f"crops/s, {a['vs_hrnet_w18']} x hrnet_w18's {hrnet_w18_crops_per_s} in this run; "
        f"{a['batch_ms']} ms a batch (forward + decode {a['forward_decode_ms']}, solver "
        f"{a['solver_ms']}); peak {a['peak_mem_gib']} GiB; {a['kernel_launches_per_batch']} "
        f"launches and {a['device_ms_per_batch']} device ms a batch")

    # --- (b) the other backbones at batch 64 -------------------------------------------
    for name in other_backbones:
        r = phase_serving(device, batch=other_batch, npoint=npoint, backbone=name, warm=1,
                          iters=1, seed=seed)
        res["serving"][name] = r
        paths[f"backbones_serving_{name}"] = r["edgeconv_launches_by_route"]
        say(f"[backbones] (b) {name} serving at batch {other_batch}: {r['batch_ms']} ms a "
            f"batch, peak {r['peak_mem_gib']} GiB, EdgeConv launches "
            f"{r['edgeconv_launches_by_route']}")

    # --- (c) card against CPU, f32 -----------------------------------------------------
    res["reference"] = {}
    for name in (serving_backbone, *other_backbones):
        r = phase_reference(device, batch=ref_batch, npoint=npoint, backbone=name, seed=seed)
        res["reference"][name] = r
        paths[f"backbones_reference_{name}"] = r["f32"]["edgeconv_launches_by_route"]

    # --- (d) timm checkpoints into a flagship PoseNet's init net -----------------------
    rng = np.random.default_rng(seed + 11)
    knn = knn_index(pc_normalize(rng.uniform(-40, 40, (npoint, 3))), 20)
    images = torch.from_numpy(rng.integers(0, 255, (timm_batch, 256, 256, 3)).astype(np.uint8))
    res["timm"] = {}
    for name in timm_backbones:
        conv = convert.CONVERTERS[name](timm_state_dict(name, rng))
        net = make_posenet(device=device, seed=seed, npoint=npoint, backbone_name=name,
                           **POSENET_CFG)
        own = {k[len("init_net.backbone."):] for k in net.state_dict()
               if k.startswith("init_net.backbone.")}
        net.load_state_dict(convert.graft_backbone(net.state_dict(), conv, into="init_net"))
        after = net.init_net.backbone.state_dict()
        unset = sorted(own - set(conv))
        differ = [k for k, v in conv.items() if not torch.equal(after[k].cpu(), v)]
        reset_launch_counts()
        with torch.inference_mode():
            out = net(normalize_image(images.to(device)), knn_tensor(knn, npoint, device))
        by_route = dict(edgeconv_fused.launches_by_route)
        finite = all(bool(torch.isfinite(out[k]).all())
                     for k in ("roi_logit", "x_logits", "y_logits", "seg_logits"))
        if unset or differ or not finite or by_route != {"tc": per_fwd, "fma": 0}:
            raise AssertionError(f"gate (d) {name}: {len(unset)} backbone entries not set, "
                                 f"{len(differ)} differ, outputs finite {finite}, launches "
                                 f"{by_route}")
        res["timm"][name] = {"entries": len(conv), "launches": by_route}
        paths[f"backbones_timm_{name}"] = by_route
        say(f"[backbones] (d) timm {name}: {len(conv)} converted entries set every backbone "
            f"entry of the init net; forward of {timm_batch} crops finite; EdgeConv launches "
            f"{by_route}")
        del net

    # --- (e) NOCS pretraining, then its graft into the pretrain CLI ---------------------
    root = Path(root) if root is not None else ROOT / "build" / "backbones_smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data, made = _fixture(root, data_root, n_test, n_train, n_scenes, n_vertices, seed)
    res["fixture"] = {"data": data, "generated": made,
                      "seconds": time.perf_counter() - t0 if on_card else None}
    over = dict(bop_path=data, tensorboard_path=str(root / "tb"), device=device.type)
    ncfg = common.resolve_cfg(str(ROOT / NOCS_CFG), "obj01", dict(
        nocs_overrides or {}, **over, check_point_path=str(root / "ckpt_nocs"),
        total_iteration=nocs_iters, log_freq=1))
    nrun = _run_cli(device, cli_nocs.main, ncfg, None, None, cli_nocs)
    losses = _logged_losses(nrun["lines"])
    k = min(5, len(losses) // 2)
    if len(losses) != nocs_iters or not np.isfinite(losses).all() \
            or not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError(f"gate (e): NOCS losses {losses}")
    nocs_ckpt = Path(ncfg["check_point_path"])
    mesh = load_ply_mesh(model_ply_path(data, "synth", 1))
    diameter = common.object_diameter(ncfg)
    crop_gt = int(ncfg.get("BoundingBox_CropSize_image", 256)) // 4
    samples = scan_bop_object(data, "synth", ncfg["training_data_folder"], 1, 0.1)
    xyz = common.load_keypoints(ncfg)[0]
    ds = CropDataset(samples, xyz, is_train=True, seed=seed, **common.crop_kw(ncfg, crop_gt))
    first = _stack_items([ds[i] for i in range(min(int(ncfg["batch_size"]), len(ds)))])
    raster = _gate_raster_and_labels(device, mesh, first, diameter, n_host_renders)
    res["nocs"] = {"iterations": nocs_iters, "batch": int(ncfg["batch_size"]),
                   "backbone": ncfg["network_backbone_name"], "logged_losses": losses,
                   "ms_per_iter": _ms_per_iter(nrun, nocs_iters) if on_card else None,
                   "peak_mem_gib": nrun["peak_mem_gib"], "launches": nrun["launches"],
                   **raster}
    if nrun["launches"] != {"tc": 0, "fma": 0}:
        raise AssertionError(f"gate (e): the NOCS run launched {nrun['launches']}")
    paths["backbones_nocs"] = nrun["launches"]
    say(f"[backbones] (e) cli.pretrain_backbone.main, {ncfg['network_backbone_name']} head "
        f"{ncfg['nocs_head_width']}, {nocs_iters} iterations at batch {ncfg['batch_size']}: "
        f"host ms an iteration {res['nocs']['ms_per_iter']}; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; peak {nrun['peak_mem_gib']} GiB; EdgeConv launches "
        f"{nrun['launches']}; rasterizer {raster['raster_device_ms_per_batch']} device ms a "
        f"batch of {raster['batch']} at S={raster['S']} ({raster['faces']} faces), against "
        f"the host z-buffer on {raster['compared_samples']} samples: coverage differs on "
        f"{raster['coverage_xor']:.4f} of the pixels (bar {RASTER_COVER_TOL}), z q99 "
        f"{raster['z_rel_q99']:.2e} (bar {RASTER_Z_Q99_TOL}); labels against float64 "
        f"{raster['label_max_abs_err']:.2e} (bar {NOCS_LABEL_TOL})")

    grafted = {}

    def capture_graft(orig):
        def wrapped(cfg, state):
            state = orig(cfg, state)
            grafted.update({k: v.detach().cpu().clone() for k, v
                            in state.module.state_dict().items() if k.startswith("backbone.")})
            return state
        return wrapped

    pcfg = common.resolve_cfg(str(ROOT / PRETRAIN_CFG), "obj01", dict(
        pretrain_overrides or {}, **over, check_point_path=str(root / "ckpt_pre"),
        total_iteration=graft_iters, test_freq=graft_iters, log_freq=1,
        backbone_pretrain_checkpoint=str(nocs_ckpt)))
    with _wrapped(common, "maybe_graft_pretrained_backbone", capture_graft):
        grun = _run_cli(device, cli_pre.main, pcfg, cli_pre, "evaluate_init", cli_pre)
    source = CheckpointManager(str(nocs_ckpt)).restore_raw()["model"]
    src_bb = {k: v for k, v in source.items() if k.startswith("backbone.")}
    said = [ln for ln in grun["lines"] if ln.startswith("grafted NOCS-pretrained backbone")]
    differ = [k for k, v in src_bb.items() if not torch.equal(grafted.get(k, torch.empty(0)), v)]
    if not said or not src_bb or differ or set(grafted) != set(src_bb):
        raise AssertionError(f"gate (e): graft line {said}, {len(differ)} of {len(src_bb)} "
                             f"backbone entries differ from the NOCS checkpoint")
    g_launches = _gate_launches(grun, INIT_EDGECONVS if on_card else 0, "gate (e)")
    res["nocs_graft"] = {"line": said[0], "entries": len(src_bb), "launches": g_launches}
    paths["backbones_nocs_graft_pretrain"] = g_launches
    say(f"[backbones] (e) '{said[0]}': all {len(src_bb)} backbone entries equal the NOCS "
        f"checkpoint's bit for bit; pretrain CLI {graft_iters} iterations, EdgeConv "
        f"launches {g_launches}")

    # --- (f) the test CLI on a resnet34 PoseNet ----------------------------------------
    tcfg = common.resolve_cfg(str(ROOT / EVAL_CFG), "obj01", dict(
        eval_overrides or {}, bop_path=data, init_network_backbone_name=serving_backbone,
        Detection_reaults=f"{data}/detection_results/synth/synth_detections.json",
        ckpt_dir=str(root / "ckpt_test"), eval_output_path=str(root / "out"),
        test_batch_size=eval_batch, device=device.type))
    net = build_pose_net(tcfg, 2 ** int(tcfg["num_p3d_log2"]))
    state = create_pose_state(net, make_optimizer(1e-4), seed=seed, device=device)
    _balance_seg_head(net, tcfg, device)
    CheckpointManager(tcfg["ckpt_dir"]).save_best(state)
    del net, state
    n_images = len(scan_bop_object(data, "synth", "test", 1, 0.1))
    forwards = -(-n_images // eval_batch)
    spans = {}
    reset_launch_counts()
    report = cli_test.main(dict(tcfg, decode_mode="hard"), spans=spans)
    _sync(device)
    by_route = dict(edgeconv_fused.launches_by_route)
    if by_route != {"tc": per_fwd * forwards, "fma": 0}:
        raise AssertionError(f"gate (f): the test CLI's EdgeConv launches {by_route} for "
                             f"{forwards} forward batches")
    csv_path = root / "out" / f"{Path(EVAL_CFG).stem}_obj01.csv"
    f_res = {"backbone": serving_backbone, "forward_batches": forwards,
             "edgeconv_launches_by_route": by_route,
             **_gate_eval_report(report, csv_path, n_images, False),
             **{k: v for k, v in _split_spans(spans, n_images).items()
                if k.startswith("images_per_s")}}
    if not on_card:
        f_res.update(images_per_s=None, images_per_s_after_first=None)
    res["test_cli"] = f_res
    paths[f"backbones_test_cli_{serving_backbone}"] = by_route
    say(f"[backbones] (f) cli.test.main with init_network_backbone_name = {serving_backbone}, "
        f"{n_images} images at batch {eval_batch}: {f_res['images_per_s']} images/s "
        f"({f_res['images_per_s_after_first']} after the first batch); report keys and "
        f"{f_res['csv_rows']} CSV rows; EdgeConv launches {by_route}")
    res["launches_by_path"] = paths
    res["seconds"] = time.perf_counter() - t_phase if on_card else None
    say(f"[backbones] phase took {res['seconds']} s")
    return res


def timm_state_dict(name, rng):
    """A timm-layout state_dict of `name` ("resnet34" as torchvision and
    timm name it, or "hrnet_w18", timm's HighResolutionNet) written by hand:
    random float32 numpy values, positive running variances, and none of
    the classification tensors."""
    sd = {}

    def conv(k, o, i, kh):
        sd[k + ".weight"] = (rng.standard_normal((o, i, kh, kh))
                             * math.sqrt(2.0 / (i * kh * kh))).astype(np.float32)

    def bn(k, c):
        sd[k + ".weight"] = rng.uniform(0.5, 1.0, c).astype(np.float32)
        sd[k + ".bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[k + ".running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[k + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    def block(pre, cin, planes, cout, n_convs):
        """A BasicBlock (two 3x3) or a Bottleneck (1x1, 3x3, 1x1), with the
        projection where the widths differ."""
        shapes = ([(cout, cin, 3), (cout, cout, 3)] if n_convs == 2 else
                  [(planes, cin, 1), (planes, planes, 3), (cout, planes, 1)])
        for i, (o, c, k) in enumerate(shapes, 1):
            conv(f"{pre}.conv{i}", o, c, k)
            bn(f"{pre}.bn{i}", o)
        if cin != cout:
            conv(f"{pre}.downsample.0", cout, cin, 1)
            bn(f"{pre}.downsample.1", cout)

    if name == "resnet34":
        conv("conv1", 64, 3, 7)
        bn("bn1", 64)
        cin = 64
        for s, (w, nb) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            for b in range(nb):
                block(f"layer{s + 1}.{b}", cin, w, w, 2)
                cin = w
        return sd
    if name != "hrnet_w18":
        raise ValueError(f"no timm layout for {name}")
    widths = (18, 36, 72, 144)
    conv("conv1", 64, 3, 3)
    bn("bn1", 64)
    conv("conv2", 64, 64, 3)
    bn("bn2", 64)
    for k in range(4):
        block(f"layer1.{k}", 64 if k == 0 else 256, 64, 256, 3)
    prev = (256,)
    for stage, modules in enumerate((1, 4, 3)):
        ws = widths[:stage + 2]
        for b in range(len(ws) - 1):
            if prev[b] != ws[b]:
                conv(f"transition{stage + 1}.{b}.0", ws[b], prev[b], 3)
                bn(f"transition{stage + 1}.{b}.1", ws[b])
        conv(f"transition{stage + 1}.{len(ws) - 1}.0.0", ws[-1], prev[-1], 3)
        bn(f"transition{stage + 1}.{len(ws) - 1}.0.1", ws[-1])
        for m in range(modules):
            pre = f"stage{stage + 2}.{m}"
            for b, w in enumerate(ws):
                for k in range(4):
                    block(f"{pre}.branches.{b}.{k}", w, w, w, 2)
            for i in range(len(ws)):
                for j in range(len(ws)):
                    fl = f"{pre}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv(f"{fl}.0", ws[i], ws[j], 1)
                        bn(f"{fl}.1", ws[i])
                    for step in range(i - j):
                        out = ws[i] if step == i - j - 1 else ws[j]
                        conv(f"{fl}.{step}.0", out, ws[j], 3)
                        bn(f"{fl}.{step}.1", out)
        prev = ws
    for b, w in enumerate(widths):
        block(f"incre_modules.{b}.0", w, 32 * 2 ** b, 128 * 2 ** b, 3)
    return sd


# ---------------------------------------------------------------------------
# phase parallel: data parallelism and the native loader
# ---------------------------------------------------------------------------

# (b)'s bars: tests/test_sharding.py's, per leaf abs < 5e-4 or rel < 1e-3 after
# an SGD step at DP_STEP_LR (tests/torch_dp_ranks.py::DP_LR: the rate at which
# those bars tell the global normalizers from DDP's per-rank ones)
DP_LEAF_ABS, DP_LEAF_REL, DP_STEP_LR = 5e-4, 1e-3, 1e-2
DP_GROUP_TIMEOUT_S = 600


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env(rank: int, world: int, port: int, local_rank: int):
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def _spawn(target, args_list, timeout: float):
    """One spawned process per argument tuple, each running target(*args);
    waits at most `timeout` seconds for them all, kills any left, and raises
    unless every one exited 0."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if alive or any(c != 0 for c in codes):
        raise RuntimeError(f"{target.__name__}: processes {alive} still running after "
                           f"{timeout} s, exit codes {codes}")


def _dp_cli_child(cfg, out_path, port, device_type, threads):
    """(a)'s process: the train CLI's `main` under torchrun's environment at
    world size 1, counted by `_run_cli`; what the gates read goes to
    `out_path` as JSON."""
    from checkerpose_tpu_torch.cli import train as cli_train
    from checkerpose_tpu_torch.parallel.mesh import make_mesh
    from checkerpose_tpu_torch.train import checkpoint
    torch.set_num_threads(threads)
    _torchrun_env(0, 1, port, 0)
    mesh = make_mesh(device_type)
    saves = []

    def counted(orig):
        def wrapped(root, state, max_to_keep):
            saves.append(["best" if Path(root).name == "best" else "rolling", int(state.step)])
            return orig(root, state, max_to_keep)
        return wrapped

    with _wrapped(checkpoint, "_save", counted):
        run = _run_cli(mesh.device, cli_train.main, cfg, cli_train, "evaluate_pipeline",
                       cli_train)
    on_card = mesh.device.type == "cuda"
    out = {"backend": mesh.backend, "world": mesh.world, "device": str(mesh.device),
           "state_world": run["out"].mesh.world, "step": run["out"].step,
           "losses": _logged_losses(run["lines"]), "saves": saves,
           "evals": [{k: e[k] for k in ("batches", "launches", "seconds")} for e in run["evals"]],
           "launches": run["launches"], "peak_mem_gib": run["peak_mem_gib"],
           "ms_per_iter": _ms_per_iter(run, int(cfg["total_iteration"])) if on_card else None}
    Path(out_path).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def _gate_dp_cli(r, iters, test_freq, per_batch, backend):
    """(a)'s gates on the child's record."""
    eval_steps = sorted(set(range(test_freq, iters + 1, test_freq)) | {iters})
    rolling = [s for kind, s in r["saves"] if kind == "rolling"]
    best = [s for kind, s in r["saves"] if kind == "best"]
    if (r["backend"], r["world"], r["state_world"], r["step"]) != (backend, 1, 1, iters):
        raise AssertionError(f"gate (a): backend {r['backend']}, world {r['world']} "
                             f"(state {r['state_world']}), step {r['step']}")
    if not r["losses"] or not np.isfinite(r["losses"]).all():
        raise AssertionError(f"gate (a): logged losses {r['losses']}")
    if rolling != eval_steps or not best or len(set(best)) != len(best) \
            or not set(best) <= set(eval_steps):
        raise AssertionError(f"gate (a): checkpoint writes {r['saves']}, expected one rolling "
                             f"save at each of {eval_steps} and one best save per new best")
    total = {"tc": 0, "fma": 0}
    for i, ev in enumerate(r["evals"]):
        want = {"tc": per_batch * ev["batches"], "fma": 0}
        if ev["launches"] != want:
            raise AssertionError(f"gate (a): eval {i} launched {ev['launches']} for "
                                 f"{ev['batches']} batches, expected {want}")
        total = {k: total[k] + ev["launches"][k] for k in total}
    if len(r["evals"]) != len(eval_steps) or r["launches"] != total:
        raise AssertionError(f"gate (a): {len(r['evals'])} evals, launches {r['launches']} "
                             f"against the evals' {total}")
    return total


def _uneven_mask_batch(rng, batch, p3d, p3dn):
    """A synthetic training batch whose rows hold different numbers of
    in-RoI keypoints (row b moves its last b/batch of them left of its
    bbox), so that shards of it hold different counts."""
    b = _train_batches(rng, 1, batch, p3d, p3dn)[0]
    n = p3d.shape[0]
    for row in range(batch):
        k = n - row * n // batch
        b["proj_xy"][row, k:, 0] = b["bbox"][row, 0] - rng.uniform(5, 40, n - k)
    return b


def _dp_step(device, cfg, knn, batch_np, lr, seed, mesh=None):
    """One f32 train step (stage 3, augmentation and teacher forcing on,
    SGD at `lr`) of a PoseNet drawn from `seed` on this process's rows of
    `batch_np`: the metrics, the module's tensors after the step, and each
    EdgeConv's argmax over K ((B, N, C') per conv, from its BatchNorm's
    train-mode output; leaky ReLU keeps the order)."""
    from checkerpose_tpu_torch.models.layers import init_params
    from checkerpose_tpu_torch.models.posenet import PoseNet, knn_tensor
    from checkerpose_tpu_torch.parallel.mesh import replicate_module, shard_batch
    from checkerpose_tpu_torch.train import steps
    from checkerpose_tpu_torch.train.state import TrainState
    net = PoseNet(**cfg, dtype=torch.float32)
    init_params(net, torch.Generator().manual_seed(seed))
    net.to(device).train()
    state = TrainState(module=net, optimizer=torch.optim.SGD(net.parameters(), lr=lr))
    if mesh is not None:
        replicate_module(net, mesh)
        state.mesh = mesh
        batch_np = shard_batch(batch_np, mesh)
    argmax = []
    hooks = [m.bn.register_forward_hook(lambda mod, i, o: argmax.append(o.argmax(2).cpu()))
             for m in _edgeconvs(net)]
    step = steps.make_train_step(net, knn_tensor(knn, cfg["npoint"], device), 3,
                                 teacher_force_prob=0.5)
    try:
        metrics = step(state, _on(device, batch_np), torch.Generator(device).manual_seed(seed))
    finally:
        for h in hooks:
            h.remove()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "argmax": argmax,
            "state": {k: v.detach().cpu() for k, v in net.state_dict().items()}}


def _dp_step_child(rank, world, port, cfg, knn, batch_np, lr, seed, out_path, device_type,
                   threads):
    """(b)'s process: rank `rank` of a gloo group on one device (gloo
    takes CUDA tensors; NCCL refuses two ranks on one card)."""
    import datetime
    import torch.distributed as dist
    from checkerpose_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(threads)
    _torchrun_env(rank, world, port, 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    mesh = make_mesh(device_type)
    res = _dp_step(mesh.device, cfg, knn, batch_np, lr, seed, mesh)
    res["backend"] = mesh.backend
    if rank != 0:
        res.pop("state")
    torch.save(res, f"{out_path}.rank{rank}")
    dist.destroy_process_group()


def _gate_dp_step(single, ranks, p0, lr):
    """(b)'s gates: the loss, then every parameter and running statistic
    against test_sharding.py's per-leaf bars; where near-ties in EdgeConv's
    max over K put leaves beyond them (the flipped argmaxes are counted), the
    gradients against phase train's gate-2 relative-L2 bars instead."""
    rows = len(ranks[0]["argmax"][0])
    flipped = [int(sum((r["argmax"][c] != single["argmax"][c][i * rows:(i + 1) * rows]).sum()
                       for i, r in enumerate(ranks)))
               for c in range(len(single["argmax"]))]
    loss, want = ranks[0]["metrics"]["loss"], single["metrics"]["loss"]
    loss_rel = abs(loss - want) / abs(want)
    report = []
    for name, a in single["state"].items():
        a, b = a.double(), ranks[0]["state"][name].double()
        ad = float((a - b).abs().max())
        rd = float(((a - b).abs() / (a.abs() + 1e-6)).max())
        if not (ad < DP_LEAF_ABS or rd < DP_LEAF_REL):
            report.append((name, ad, rd))
    res = {"loss": loss, "loss_single": want, "loss_rel_err": loss_rel,
           "leaves_beyond_bar": len(report),
           "worst_leaves": sorted(report, key=lambda x: -x[1])[:5],
           "argmax_flipped_per_edgeconv": flipped,
           "argmax_entries_per_edgeconv": int(single["argmax"][0].numel())}
    if loss_rel > 1e-4:
        raise AssertionError(f"gate (b): loss {loss} against one process's {want}")
    if report:
        names = [n for n in p0 if n in dict(single["state"]) and not n.endswith(
            ("running_mean", "running_var"))]
        grads = {k: {n: (p0[n] - s["state"][n]) / lr for n in names}
                 for k, s in (("dp", ranks[0]), ("single", single))}
        rel, (leaf_err, leaf) = _rel_l2(grads["dp"], grads["single"])
        stat_err = max(float(((ranks[0]["state"][n] - v).abs() / (1.0 + v.abs())).max())
                       for n, v in single["state"].items() if n.endswith(("mean", "var")))
        res.update(gate="relative L2 (phase train's gate-2 bars)", grad_rel_l2=rel,
                   worst_leaf=leaf, worst_leaf_max_rel=leaf_err, running_stat_max_rel_err=stat_err)
        if rel > GRAD_GLOBAL_TOL or leaf_err > GRAD_LEAF_TOL or stat_err > STAT_TOL:
            raise AssertionError(f"gate (b): the 2-rank step disagrees with one process's: {res}")
    else:
        res["gate"] = "per leaf (test_sharding.py's bars)"
    return res


def _native_toolchain_missing():
    """What the native core's build needs and this host lacks (g++, png.h,
    jpeglib.h): the probe of (c)."""
    import shutil
    if shutil.which("g++") is None:
        return ["g++"]
    missing = []
    for header in ("png.h", "jpeglib.h"):
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                              capture_output=True, text=True, timeout=60)
        if proc.returncode != 0:
            missing.append(header)
    return missing


def _csv_poses(path):
    """{(scene_id, im_id): (R row-major, t) as 12 floats} of a BOP19 CSV."""
    with open(path) as f:
        rows = [ln.rstrip("\n").split(",") for ln in f.readlines()[1:]]
    return {(int(r[0]), int(r[1])): np.array(r[4].split() + r[5].split(), np.float64)
            for r in rows}


def _loader_runs(device, cfg, n_images, batch, paths):
    """(c): the test CLI on each of `paths` ("native": the default where the
    core builds; "python": forced). Gates on every run: its launches and
    images, the native counters (above 0 on the native run only). With both
    runs, the first batches (images within one grey level, as
    tests/test_native_loader.py holds the core to cv2: the core rounds its
    bilinear taps in floating point, cv2 and the python path in 11-bit
    fixed point; masks, boxes and valid exact) and the CSVs (the same rows,
    finite poses)."""
    from contextlib import nullcontext
    from checkerpose_tpu_torch.cli import common, test as cli_test
    from checkerpose_tpu_torch.data import native_loader
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
    on_card = device.type == "cuda"
    forwards = -(-n_images // batch)
    runs, firsts, poses = {}, {}, {}
    for path in paths:
        run_cfg = dict(cfg, eval_output_path=str(Path(cfg["eval_output_path"]) / path))
        patch = (_wrapped(native_loader, "available", lambda orig: lambda: False)
                 if path == "python" else nullcontext())
        with patch:
            native_loader.reset_counts()
            reset_launch_counts()
            spans = {}
            _sync(device)
            t0 = time.perf_counter()
            report = cli_test.main(run_cfg, spans=spans)
            _sync(device)
            wall = time.perf_counter() - t0
            counts = dict(native_loader.counts)
            # the first batch from the dataset itself: a loader's prefetch thread
            # would go on loading after it and count into the next run
            ds = common.build_test_loader(run_cfg, common.load_keypoints(run_cfg)[0])[0].ds
            firsts[path] = (ds.get_batch(np.arange(batch)) if ds.supports_batch()
                            else _stack_items([ds[i] for i in range(batch)]))
        by_route = dict(edgeconv_fused.launches_by_route)
        want = {"tc": EDGECONV_PER_FORWARD * forwards if on_card else 0, "fma": 0}
        if by_route != want or report["n_images"] != n_images:
            raise AssertionError(f"gate (c): {path} run: launches {by_route} (expected "
                                 f"{want}), {report['n_images']} images")
        if (path == "native") != (counts["batches"] > 0 and counts["items"] >= n_images) \
                or (path == "python" and any(counts.values())):
            raise AssertionError(f"gate (c): native counters {counts} on the {path} run")
        split = _split_spans(spans, n_images)
        runs[path] = {"native_counts": counts, "launches": by_route,
                      "cli_wall_s": wall if on_card else None,
                      "images_per_s": split["images_per_s"] if on_card else None,
                      "images_per_s_after_first": (split["images_per_s_after_first"]
                                                   if on_card else None),
                      "loader_wait_ms_per_batch": (split["ms_per_batch"]["loader"]
                                                   if on_card else None),
                      "loader_wait_ms_after_first": (
                          split["ms_per_batch_after_first"]["loader"] if on_card else None)}
        poses[path] = _csv_poses(Path(run_cfg["eval_output_path"])
                                 / f"{Path(EVAL_CFG).stem}_obj01.csv")
        if len(poses[path]) != n_images or not all(np.isfinite(v).all()
                                                   for v in poses[path].values()):
            raise AssertionError(f"gate (c): the {path} run's CSV holds {len(poses[path])} "
                                 f"rows for {n_images} images, or a non-finite pose")
    out = {"runs": runs}
    if len(paths) == 2:
        img = np.abs(firsts["native"]["image"].astype(np.int32)
                     - firsts["python"]["image"].astype(np.int32))
        exact = {k: bool(np.array_equal(firsts["native"][k], firsts["python"][k]))
                 for k in ("mask_visib", "mask_full", "bbox", "valid")}
        if img.max() > 1 or not all(exact.values()):
            raise AssertionError(f"gate (c): first batches: image max |diff| {img.max()}, "
                                 f"exact {exact}")
        a, b = poses["native"], poses["python"]
        if sorted(a) != sorted(b):
            raise AssertionError("gate (c): the two CSVs hold other rows")
        err = np.array([np.abs(a[k] - b[k]).max() for k in a])
        out.update(first_batch_image_max_abs_diff=int(img.max()),
                   first_batch_image_share_equal=float((img == 0).mean()),
                   first_batch_exact=exact, csv_pose_max_abs_diff=float(err.max()),
                   csv_rows_within_1e5=float((err <= 1e-5).mean()))
    return out


def phase_parallel(device, data_root=None, init_root=None, root=None, batch=64, iters=20,
                   test_freq=10, log_freq=5, cfg_overrides=None, step_cfg=None, step_batch=8,
                   native_test=512, native_scenes=2, native_vertices=2048,
                   single_train=None, timeout=900, seed=0):
    """Data parallelism and the native loader: (a) the train CLI under
    torchrun's environment at world size 1 (NCCL on the card, gloo on the
    CPU) on phase workflow's fixture (`data_root`) from its pretrained init
    net (`init_root`); (b) one f32 train step on 2 gloo ranks on the one
    device against one process on the same batch; (c) the test CLI over PNG
    frames without a frame cache on the python path and, where the host has
    the core's headers, on the native core. Gates raise.
    `single_train`: phase workflow's train CLI result, for (a)'s comparison."""
    import shutil
    from checkerpose_tpu_torch.cli import common
    from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
    from checkerpose_tpu_torch.models.layers import init_params
    from checkerpose_tpu_torch.models.posenet import PoseNet
    from checkerpose_tpu_torch.ops.knn import knn_index

    on_card = device.type == "cuda"
    root = Path(root) if root is not None else ROOT / "build" / "parallel_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    if data_root is None:
        data_root = root / "data"
        make_synthetic_bop(str(data_root), n_objects=1, n_scenes=1,
                           folders={"test": 4, "train_real": batch}, n_vertices=native_vertices,
                           raw_cache=True, write_png=False, seed=seed)
    data = str(data_root)
    res = {}
    if on_card:
        torch.cuda.empty_cache()              # the processes below share the card

    # --- (a) the train CLI under torchrun's environment -------------------------------
    overrides = dict(cfg_overrides or {}, bop_path=data, tensorboard_path=str(root / "tb"),
                     log_freq=log_freq, device=device.type,
                     check_point_path=str(root / "ckpt_dp"), total_iteration=iters,
                     test_freq=test_freq,
                     Detection_reaults=f"{data}/detection_results/synth/synth_detections.json")
    if init_root is not None:
        overrides["init_pretrained_root"] = str(init_root)
    tcfg = common.resolve_cfg(str(ROOT / EVAL_CFG), "obj01", overrides)
    out_a = root / "dp_cli.json"
    t0 = time.perf_counter()
    # the child takes the intra-op threads this process would use: ranks that
    # share a host's cores with more threads than cores spin on each other
    threads = torch.get_num_threads()
    _spawn(_dp_cli_child, [(tcfg, str(out_a), _free_port(), device.type, threads)], timeout)
    child_s = time.perf_counter() - t0
    r = json.loads(out_a.read_text())
    launches = _gate_dp_cli(r, iters, test_freq, EDGECONV_PER_FORWARD if on_card else 0,
                            "nccl" if on_card else "gloo")
    so = (single_train or {}).get("ms_per_iter") or {}
    res["dp_train"] = {"backend": r["backend"], "world": r["world"], "iterations": iters,
                       "logged_losses": r["losses"], "saves": r["saves"],
                       "eval_batches": [e["batches"] for e in r["evals"]],
                       "eval_s": [e["seconds"] for e in r["evals"]] if on_card else None,
                       "ms_per_iter": r["ms_per_iter"], "peak_mem_gib": r["peak_mem_gib"],
                       "single_process_ms_per_iter": so or None, "launches": launches,
                       "process_s": child_s if on_card else None}
    say(f"[parallel] (a) torchrun's environment, world {r['world']}, backend {r['backend']} "
        f"on {r['device']}: cli.train.main {iters} iterations at batch {tcfg['batch_size']}, "
        f"eval every {test_freq}: host ms an iteration without the evals {r['ms_per_iter']} "
        f"against the single-process train CLI's {so or None} (phase workflow, this run); "
        f"evals {res['dp_train']['eval_s']} s; EdgeConv launches {launches} = "
        f"{EDGECONV_PER_FORWARD} x {sum(res['dp_train']['eval_batches'])} eval batches; "
        f"losses finite ({r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}); checkpoint writes "
        f"{r['saves']}, each once; peak {r['peak_mem_gib']} GiB; the process took "
        f"{res['dp_train']['process_s']} s start to end")

    # --- (b) two gloo ranks on one device against one process ------------------------
    cfg = dict(step_cfg or dict(npoint=512, backbone_name="hrnet_w18", **POSENET_CFG))
    rng = np.random.default_rng(seed + 11)
    p3d = rng.uniform(-40, 40, (cfg["npoint"], 3))
    p3dn = (p3d - p3d.mean(0)) / np.linalg.norm(p3d - p3d.mean(0), axis=1).max()
    knn = knn_index(p3dn, cfg.pop("knn_k", 20))
    batch_np = _uneven_mask_batch(rng, step_batch, p3d, p3dn.astype(np.float32))
    single = _dp_step(device, cfg, knn, batch_np, DP_STEP_LR, seed)
    p0 = PoseNet(**cfg, dtype=torch.float32)
    init_params(p0, torch.Generator().manual_seed(seed))
    p0 = {k: v.detach() for k, v in p0.state_dict().items()}
    if on_card:
        torch.cuda.empty_cache()
    out_b = root / "dp_step.pt"
    port = _free_port()
    _spawn(_dp_step_child, [(rank, 2, port, cfg, knn, batch_np, DP_STEP_LR, seed, str(out_b),
                             device.type, max(1, threads // 2)) for rank in range(2)], timeout)
    ranks = [torch.load(f"{out_b}.rank{r}", weights_only=True) for r in range(2)]
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"gate (b): backends {[r['backend'] for r in ranks]}")
    res["dp_step"] = _gate_dp_step(single, ranks, p0, DP_STEP_LR)
    in_roi = [int(((batch_np["proj_xy"][b, :, 0] >= batch_np["bbox"][b, 0])).sum())
              for b in range(step_batch)]
    say(f"[parallel] (b) one f32 train step (stage 3, augmentation and teacher forcing on, "
        f"SGD {DP_STEP_LR:g}) of a PoseNet at npoint {cfg['npoint']}, {cfg['backbone_name']}, "
        f"K {knn.shape[1]}: 2 gloo ranks x {step_batch // 2} rows on {device.type} against one "
        f"process at batch {step_batch} (in-RoI keypoints by row {in_roi}): {res['dp_step']}")

    # --- (c) the loaders over PNG frames, native and python ---------------------------
    missing = _native_toolchain_missing()
    paths = ("python",) if missing else ("native", "python")
    ndata = str(root / "native_data")
    t0 = time.perf_counter()
    make_synthetic_bop(ndata, n_objects=1, n_scenes=native_scenes,
                       folders={"test": native_test // native_scenes},
                       n_vertices=native_vertices, raw_cache=False, write_png=True, seed=seed)
    fixture_s = time.perf_counter() - t0
    if (Path(ndata) / "synth" / "frame_cache").exists():
        raise AssertionError("gate (c): the fixture has a frame cache (no PNG codec here?)")
    qcfg = dict(common.resolve_cfg(str(ROOT / EVAL_CFG), "obj01", dict(
        cfg_overrides or {}, bop_path=ndata, device=device.type,
        Detection_reaults=f"{ndata}/detection_results/synth/synth_detections.json")),
        ckpt_dir=tcfg["check_point_path"], eval_output_path=str(root / "out"),
        test_batch_size=batch, decode_mode="hard")
    loaders = _loader_runs(device, qcfg, native_test, batch, paths)
    loaders.update(fixture_s=fixture_s if on_card else None,
                   native_left_out=(f"this host lacks {missing}: the native core "
                                    "(native/loadercore.cpp) cannot build here"
                                    if missing else None))
    res["native_loader"] = loaders
    if missing:
        say(f"[parallel] (c) native half left out: {loaders['native_left_out']}")
    for path, run in loaders["runs"].items():
        say(f"[parallel] (c) test CLI, {path} loader, {native_test} PNG frames (no frame cache) "
            f"at batch {batch}: {run['images_per_s']} eval images/s over the sweep, "
            f"{run['images_per_s_after_first']} after the first batch; loader wait "
            f"{run['loader_wait_ms_per_batch']} ms a batch ({run['loader_wait_ms_after_first']} "
            f"after the first); native counters {run['native_counts']}; EdgeConv launches "
            f"{run['launches']}; fixture {loaders['fixture_s']} s")
    if not missing:
        say(f"[parallel] (c) first batches native vs python: image max |diff| "
            f"{loaders['first_batch_image_max_abs_diff']} grey level (bar 1), "
            f"{loaders['first_batch_image_share_equal']:.4f} of values equal; masks, boxes, "
            f"valid equal {loaders['first_batch_exact']}; CSV pose max |diff| "
            f"{loaders['csv_pose_max_abs_diff']}, {loaders['csv_rows_within_1e5']:.4f} of the "
            f"rows within 1e-5")
    return res

KERNELS = {
    "tc": dict(name="edgeconv_fused_tc", source="checkerpose_tpu_torch/csrc/edgeconv_tc.cu",
               dtype="bfloat16", phase="serving",
               path="bf16 serving forward (phase serving); also the eval forward of the "
                    "trained weights (phase train), every forward batch of the test "
                    "CLI (phase eval) and every eval batch of the pretrain and train "
                    "CLIs (phase workflow); 0 on the LM paths (phase lm: a per-sample "
                    "graph takes the plain per-sample path, as in the JAX package); phase "
                    "backbones: serving on resnet34 (the slice's main path) and the other "
                    "backbones, the timm grafts, the pretrain CLI after the NOCS graft and "
                    "the test CLI on resnet34; 0 in NOCS pretraining; phase parallel: 11 an "
                    "eval batch of the data-parallel train CLI (and of the native-loader "
                    "test CLI where that runs); 0 in the 2-rank f32 step"),
    "fma": dict(name="edgeconv_fused_fma", source="checkerpose_tpu_torch/csrc/edgeconv.cu",
                dtype="float32", phase="reference",
                path="f32 forward (phase reference, and phase backbones (c) on every "
                     "backbone); the bf16 serving path no longer launches this kernel"),
}


def _per_forward(rows, route, dtype):
    """A kernel's rows at the main-path widths in `dtype` -> (max |err|,
    {ms, plain_ms, bound_ms} summed over one forward's launches, bound_by)."""
    main = [r for r in rows if r["kernel"] == route and r["dtype"] == dtype
            and not r["ragged"] and r["C"] in MAIN_WIDTHS]

    def per_forward(key):
        if any(r[key] is None for r in main):
            return None                          # not measured (no card)
        return sum(MAIN_WIDTHS[r["C"]] * r[key] for r in main)

    bound_by = max(main, key=lambda r: MAIN_WIDTHS[r["C"]] * r["bound_ms"])["bound_by"]
    return (max(r["max_abs_err"] for r in main),
            {key: per_forward(key) for key in ("ms", "plain_ms", "bound_ms")}, bound_by, main)


def kernel_summary(rows, launches_by_route, train_eval_launches=None, eval_launches=None,
                   eval_rows=None, paths=None):
    """One entry per kernel for the JSON line. `launches` is the count of
    the path that runs the kernel (the serving phase for the tensor-core
    kernel, the reference phase's f32 forward for the FMA kernel);
    `launches_by_path` adds the count of the eval forward that ends the train
    phase and, when given, of the eval phase's hard run of the test CLI and
    of each path in `paths` ({name: launches by route}, the workflow phase's
    CLI runs), each path counted from 0. Times are per forward of that path: 2 launches at
    C=C'=64 + 9 at C=C'=256 in the path's dtype; `eval_rows` (the kernels
    held against the plain version at the eval batch) add the same figures
    at that batch under `at_eval_batch`."""
    entries = []
    for route, k in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == route]
        max_err, times, bound_by, main = _per_forward(rows, route, k["dtype"])
        entries.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": "checkerpose_tpu/ops/pallas_edgeconv.py:79",
            "launches": launches_by_route[route], "launches_on": k["path"],
            "launches_by_path": {k["phase"]: launches_by_route[route],
                                 "train_eval": (train_eval_launches or {}).get(route),
                                 **({"eval": eval_launches.get(route)}
                                    if eval_launches is not None else {}),
                                 **{name: by_route.get(route)
                                    for name, by_route in (paths or {}).items()}},
            "max_abs_err": max_err, **times, "bound_by": bound_by,
            "library_ms": None,
            "per": f"one forward: 2 launches at C=C'=64 + 9 at C=C'=256, {k['dtype']}, "
                   f"B={main[0]['B']} N={main[0]['N']} K={main[0]['K']}",
            "shapes": mine,
        })
        if eval_rows is not None:
            e_err, e_times, e_by, e_main = _per_forward(eval_rows, route, k["dtype"])
            entries[-1]["at_eval_batch"] = {"B": e_main[0]["B"], "max_abs_err": e_err,
                                            **e_times, "bound_by": e_by}
    return entries


def parallel_launches(parallel):
    """Phase parallel's paths for the kernels line: the DP train CLI's evals
    and, where (c) ran, the native and python test CLI runs."""
    out = {"parallel_dp_train": parallel["dp_train"]["launches"]}
    for path, run in parallel["native_loader"]["runs"].items():
        out[f"parallel_{path}_loader_test"] = run["launches"]
    return out


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
    t_start = time.perf_counter()

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
    evaluation = phase_eval(device, seed=args.seed)
    workflow = phase_workflow(device, seed=args.seed)
    lm = phase_lm(device, seed=args.seed, single_object_train=workflow["train"])
    backbones = phase_backbones(device, seed=args.seed,
                                data_root=ROOT / "build" / "workflow_smoke" / "data",
                                hrnet_w18_crops_per_s=serving["crops_per_s"])
    parallel = phase_parallel(
        device, seed=args.seed, data_root=ROOT / "build" / "workflow_smoke" / "data",
        init_root=ROOT / "build" / "workflow_smoke" / "ckpt_pre" / Path(PRETRAIN_CFG).stem,
        single_train=workflow["train"])

    launches = {"tc": serving["edgeconv_launches_by_route"]["tc"],
                "fma": reference["f32"]["edgeconv_launches_by_route"]["fma"]}
    print(json.dumps({"serving": serving, "fold": fold, "card": card}))
    print(json.dumps({"train": train, "card": card}))
    eval_rows = evaluation.pop("kernel_rows")
    print(json.dumps({"eval": evaluation, "card": card}))
    print(json.dumps({"workflow": workflow, "card": card}))
    print(json.dumps({"lm": lm, "card": card}))
    print(json.dumps({"backbones": backbones, "card": card}))
    print(json.dumps({"parallel": parallel, "card": card}))
    script_s = time.perf_counter() - t_start
    say(f"[script] {script_s:.1f} s from the start to the end of the last phase")
    lm_paths = lm["launches_by_path"]
    print(json.dumps({"kernels": kernel_summary(
        rows, launches, train["eval_after_training"]["edgeconv_launches_by_route"],
        evaluation["hard"]["edgeconv_launches_by_route"], eval_rows,
        {**workflow["launches_by_path"], **lm_paths, **backbones["launches_by_path"],
         **parallel_launches(parallel)}),
        "lm_path_launches": {k: sum(p[k] for p in lm_paths.values())
                             for k in ("tc", "fma", "per_sample")},
        "script_s": script_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
