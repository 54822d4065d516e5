"""Where a launch of the FMA EdgeConv kernel goes: csrc/edgeconv.cu timed on
the card beside builds of it with a part taken out.

    python -m checkerpose_tpu_torch.tools.edgeconv_ablation [--B 512] [--N 512]
        [--K 20] [--widths 64 256] [--iters 20] [--seed 0]

Builds, each a text substitution of the source (asserted to apply), made
with the port's nvcc flags under `build/ablation/` and never loaded by the
port:
  kernel      the source as the port builds it;
  no_gather   pass 1 reads no neighbour's y row (nor, then, its index);
  no_copies   no tile is copied and none waited for (the products read
              whatever the ring holds);
  bare        neither: the products, the y stores and the outputs alone.
Each runs on the same f32 inputs at C = C' = each width (the TMA path), timed
with CUDA events in two turns (the builds in order, then reversed); the
difference to `kernel` is what that part costs a launch where it does not
overlap the rest. Prints one line a width and one JSON line, each with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

from checkerpose_tpu_torch.ops import _build

NO_GATHER = [("for (int g = 0; g < CB / 32; ++g) {\n    const float4 v",
              "for (int g = 0; g < 0; ++g) {\n    const float4 v")]
NO_COPIES = [("if (at.pass < 2 && threadIdx.x == 0) {", "if (false) {"),
             ("if (at.pass < 2) {", "if (false) {"),
             ("mbar_wait(&full[st], (s / STAGES) & 1);", ";")]
BUILDS = {"kernel": [], "no_gather": NO_GATHER, "no_copies": NO_COPIES,
          "bare": NO_COPIES + NO_GATHER}


def variant_sources() -> Dict[str, str]:
    """The source of each build; raises if a substitution no longer applies."""
    src = _build.SOURCES["edgeconv"].read_text()
    out = {}
    for name, subs in BUILDS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"build {name}: {old!r} is not in csrc/edgeconv.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_all(out_dir: Path) -> Dict[str, ctypes.CDLL]:
    """One nvcc per build, all at once; the libraries typed as route "fma"."""
    from checkerpose_tpu_torch.ops.edgeconv import _typed
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build {name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = _typed(ctypes.CDLL(str(lib)), "fma")
    return libs


def time_builds(libs, B: int, N: int, K: int, C: int, iters: int, seed: int) -> Dict[str, list]:
    """ms a launch of each build at C = C' in f32, two turns each."""
    from checkerpose_tpu_torch.ops.knn import knn_index
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    knn = torch.as_tensor(knn_index(torch.randn(N, 3, generator=g).numpy(), K), device=dev)
    x = torch.randn(B, N, C, generator=g).to(dev)
    w1, w2m1 = (torch.randn(C, C, generator=g).div(C ** 0.5).to(dev) for _ in range(2))
    scale = (0.5 + torch.rand(C, generator=g)).to(dev)
    bias = torch.zeros(C, device=dev)
    out = torch.empty(B, N, C, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        err = lib.edgeconv_fused_launch(0, x.data_ptr(), knn.data_ptr(), w1.data_ptr(),
                                        w2m1.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                        out.data_ptr(), B, N, C, C, K, 0.2, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    ms = {name: [] for name in libs}
    for name in [*libs, *reversed(list(libs))]:
        for _ in range(2):
            launch(libs[name])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            launch(libs[name])
        end.record()
        torch.cuda.synchronize(dev)
        ms[name].append(start.elapsed_time(end) / iters)
    return ms


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=512)
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--widths", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("edgeconv_ablation: no CUDA device; it times the card only", file=sys.stderr)
        return 1
    name = card()
    libs = build_all(_build.BUILD_DIR / "ablation")
    res = {}
    for C in args.widths:
        res[C] = time_builds(libs, args.B, args.N, args.K, C, args.iters, args.seed)
        print(f"[ablation] B={args.B} N={args.N} K={args.K} C=C'={C} f32, ms a launch in two "
              f"turns: " + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in res[C].items())
              + f" [{name}]")
    print(json.dumps({"ablation_ms": res, "B": args.B, "N": args.N, "K": args.K,
                      "card": name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
