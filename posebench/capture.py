"""What the timed path served, kept for the comparison with the reference.

`Capture` keeps k of the window's batches, drawn from the seed by reservoir
sampling, without a copy or a synchronisation: references to the
network's outputs (from a forward hook on the program's PoseNet) and to
the solver's inputs and answers (from a wrapper around the program's
solver entry), beside the inputs the harness handed over.

`inference_numbers` then judges the kept batches, once the window is closed:

* the network, on sampled crops: the float32 reference runs with its refine
  stages gathering at the served cells, and every served bit (RoI, 6 x and
  6 y bits, the seg bit of each channel the decode reads at the served
  cell) and the program's logit of it are scored against the reference's
  logit (`BitJudge`): the share decided the other way, the median and the
  99th percentile of the logit error, and the mean of the 8 widest margins
  on the wrong side, each also as a ratio to what the same reference in
  bfloat16 gives;
* decode_px_max, valid_mismatch: the solver's 2D points against the
  reference decode of the served ids, and its validity mask against the
  served RoI and seg bits, over every crop of the batch;
* pose_violations: what each served pose claims (poses.pose_violations)
  against the reference's float64 reprojection, over every crop.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from posebench.reference import poses as ref_poses

SEG_CHANNEL = {"visib": 0, "full": 1}
TOP_GAPS = 8                          # the widest margins a gap reading averages


class Capture:
    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k, self.n = rng, k, 0
        self.kept: Dict[int, dict] = {}
        self.current: Optional[dict] = None
        self.meta: Optional[dict] = None
        self.on = False

    def forward_hook(self, module, args, out):
        if not self.on:
            return
        rec = {"meta": self.meta, **{k: out[k] for k in ("x_id", "y_id", "roi_logit",
                                                         "x_logits", "y_logits",
                                                         "seg_logits")}}
        n, self.n = self.n, self.n + 1
        slot = n if n < self.k else int(self.rng.integers(0, n + 1))
        self.current = rec if slot < self.k else None
        if slot < self.k:
            self.kept[slot] = rec

    def wrap_solver(self, fn):
        def solver(p3d, p2d, valid, K, generator=None, **kw):
            out = fn(p3d, p2d, valid, K, generator, **kw)
            if self.on and self.current is not None:
                self.current["solver"] = {"p3d": p3d, "p2d": p2d, "valid": valid, "K": K,
                                          "thresh": float(kw.get("reproj_thresh", 2.0)),
                                          "out": out}
            return out
        return solver

    def records(self) -> List[dict]:
        return [self.kept[s] for s in sorted(self.kept)]


def served(rec, rows, channels):
    """The served decisions {0,1} and the program's logits of them, each
    (R, N, 1 + 2 * bits + len(channels)): RoI, x bits, y bits, and the seg
    channels read at the served cells."""
    x, y = rec["x_id"][rows].long(), rec["y_id"][rows].long()
    L = rec["x_logits"].shape[-1]
    S = 2 ** L
    shifts = torch.arange(L - 1, -1, -1, device=x.device)
    roi = rec["roi_logit"][rows].reshape(x.shape).float()
    seg = [ref_poses.seg_at(rec["seg_logits"][rows][..., c].float(), x, y, S)
           for c in channels]
    bits = torch.cat([(roi > 0).long()[..., None], (x[..., None] >> shifts) & 1,
                      (y[..., None] >> shifts) & 1] + [(s > 0).long()[..., None] for s in seg],
                     -1)
    logits = torch.cat([roi[..., None], rec["x_logits"][rows].float(),
                        rec["y_logits"][rows].float()] + [s[..., None] for s in seg], -1)
    return bits, logits


def reference_logits(ref_net, imgs, knn, forced, channels, block: int) -> torch.Tensor:
    """The reference's logits of every served bit, in row blocks, its
    refine stages gathering at the forced cells: (R, N, 1 + 2 * bits + len(channels))."""
    outs = []
    with torch.no_grad():
        for a in range(0, imgs.shape[0], block):
            sl = slice(a, a + block)
            kn = knn[sl] if knn.dim() == 3 else knn
            f = {k: v[sl] for k, v in forced.items()}
            o = ref_net(imgs[sl], kn, forced=f)
            S = 2 ** o["x_logits"].shape[-1]
            cols = [o["roi_logit"][..., None], o["x_logits"], o["y_logits"]]
            for c in channels:
                cols.append(ref_poses.seg_at(o["seg_logits"][..., c], f["x_id"], f["y_id"],
                                             S)[..., None])
            outs.append(torch.cat(cols, -1))
    return torch.cat(outs)


class BitJudge:
    """Scores served bits and logits against the float32 reference's logits
    at the same cells, beside the same reference computed in the
    configuration's precision (bfloat16 operands), which shows what rounding
    alone moves on these weights and inputs. Every logit is measured in the
    median |logit| of its column (bit position) in the float32 reference."""

    def __init__(self):
        self.n = 0
        self.flips = {"prog": 0, "bf16": 0}
        self.errs = {"prog": [], "bf16": []}
        self.gaps = {"prog": [], "bf16": []}

    def add(self, bits, logits, ref32, ref16):
        scale = ref32.abs().flatten(0, 1).median(0).values.clamp_min(1e-12)
        for side, sign, lg in (("prog", 2.0 * bits - 1.0, logits),
                               ("bf16", torch.where(ref16 > 0, 1.0, -1.0), ref16)):
            self.flips[side] += int((sign * ref32 < 0).sum())
            self.errs[side].append(((lg - ref32).abs() / scale).flatten(0, 1))
            gap = (torch.relu(-sign * ref32) / scale).flatten()
            self.gaps[side].append(gap.topk(min(TOP_GAPS, gap.numel())).values)
        self.n += bits.numel()

    def _gap(self, side) -> float:
        """The mean of the TOP_GAPS widest margins on the wrong side."""
        return float(torch.cat(self.gaps[side]).topk(TOP_GAPS).values.mean())

    def numbers(self) -> Dict[str, float]:
        errs = {s: torch.cat(e).double() for s, e in self.errs.items()}        # (n, cols)
        p99 = {s: float(torch.quantile(e.flatten()[:2 ** 24], 0.99)) for s, e in errs.items()}
        p50 = {s: float(e.flatten().median()) for s, e in errs.items()}
        return {"bit_flip_share": self.flips["prog"] / self.n,
                "bit_flip_share_bf16": self.flips["bf16"] / self.n,
                "bit_flip_ratio": self.flips["prog"] / max(self.flips["bf16"], 1),
                "logit_err_p99": p99["prog"], "logit_err_p99_bf16": p99["bf16"],
                "logit_err_ratio": p99["prog"] / max(p99["bf16"], 1e-12),
                "logit_err_p50": p50["prog"], "logit_err_p50_ratio": p50["prog"] / max(
                    p50["bf16"], 1e-30),
                "bit_gap_top": self._gap("prog"), "bit_gap_top_bf16": self._gap("bf16"),
                "bit_gap_ratio": self._gap("prog") / max(self._gap("bf16"), 1e-12),
                "bits_compared": float(self.n)}


def _both_references(ref_net, imgs, knn, forced, channels, block):
    from posebench.reference import model as ref
    ref32 = reference_logits(ref_net, imgs, knn, forced, channels, block)
    ref.set_quant(ref_net, "bf16")
    try:
        ref16 = reference_logits(ref_net, imgs, knn, forced, channels, block)
    finally:
        ref.set_quant(ref_net, None)
    return ref32, ref16


def _sample(rec, meta, rows_per_batch, rng, normalize):
    """Rows drawn from the batch's real crops (`meta["real"]`, where the
    harness padded the batch with copies; all of them otherwise), their
    reference inputs and graph."""
    B = int(meta.get("real", rec["x_id"].shape[0]))
    dev = rec["x_id"].device
    rows = torch.as_tensor(np.sort(rng.choice(B, size=min(rows_per_batch, B), replace=False)),
                           device=dev)
    imgs = normalize(meta["images"][rows.to(meta["images"].device)].to(dev))
    knn = meta["knn"][rows] if meta["knn"].dim() == 3 else meta["knn"]
    return rows, imgs, knn


def inference_numbers(records, ref_net, normalize, rows_per_batch: int, rng, block: int,
                      channels, modes) -> Dict[str, float]:
    """The numbers compared, over the kept batches (see the module's docstring).
    `normalize` turns a batch's uint8 crops into the reference's input;
    `modes`: the decode's filter modes, in the order the solver stacks them."""
    judge = BitJudge()
    decode_px, valid_bad, crops, solved, kinds = 0.0, 0, 0, 0, {}
    for rec in records:
        meta, sol = rec["meta"], rec["solver"]
        L = rec["x_logits"].shape[-1]
        rows, imgs, knn = _sample(rec, meta, rows_per_batch, rng, normalize)
        forced = {"x_id": rec["x_id"][rows], "y_id": rec["y_id"][rows],
                  "roi": (rec["roi_logit"][rows].reshape(rec["x_id"][rows].shape) > 0)}
        judge.add(*served(rec, rows, channels),
                  *_both_references(ref_net, imgs, knn, forced, channels, block))

        # decode and poses, every crop of the batch, each filter mode
        S = 2 ** L
        bbox = meta["bbox"].to(rec["x_id"].device)
        p2d_ref = ref_poses.decode(rec["x_id"], rec["y_id"], bbox, S)
        roi = (rec["roi_logit"].reshape(rec["x_id"].shape) > 0).double()
        valid_ref = []
        for mode in modes:
            v = roi
            if mode != "none":
                seg = ref_poses.seg_at(rec["seg_logits"][..., SEG_CHANNEL[mode]],
                                       rec["x_id"], rec["y_id"], S)
                v = v * (torch.sigmoid(seg.float()) > 0.5).double()
            valid_ref.append(v)
        valid_ref = torch.cat(valid_ref)
        nm = len(modes)
        p2d_ref = p2d_ref.repeat(nm, 1, 1)
        p2d = sol["p2d"].double()
        decode_px = max(decode_px, float((p2d - p2d_ref).abs().amax()))
        valid_bad += int((sol["valid"].double() != valid_ref).sum())
        out = sol["out"]
        n = p2d.shape[0]
        p3d = sol["p3d"].expand(n, *sol["p3d"].shape[-2:]) if sol["p3d"].dim() == 2 \
            else sol["p3d"]
        K = sol["K"].expand(n, 3, 3) if sol["K"].dim() == 2 else sol["K"]
        parts = ref_poses.pose_violations(
            out["R"], out["t"], out["inliers"], out["num_inliers"], out["success"],
            valid_ref, p3d, p2d_ref, K, sol["thresh"], 1e-2)
        for k, v in parts.items():
            kinds[k] = kinds.get(k, 0) + int(v.sum())
        solved += int(out["success"].sum())
        crops += n
    return {**judge.numbers(),
            "decode_px_max": decode_px, "valid_mismatch": float(valid_bad),
            "pose_violations": float(sum(kinds.values())),
            "poses_compared": float(crops), "poses_solved": float(solved),
            **{f"pose_{k}": float(v) for k, v in kinds.items()}}


def control_numbers(records, ref_net, normalize, rows_per_batch: int, rng, block: int,
                    channels) -> Dict[str, float]:
    """The control: the reference put in the program's place with every
    product's operands in float8 (`ref.set_quant(net, "fp8")`), on the kept
    batches' crops; its own decisions and logits are then judged as the
    program's are, and its cells decoded in bfloat16 (the decode's own
    precision is float32) against the float64 decode."""
    from posebench.reference import model as ref
    judge = BitJudge()
    decode_px = 0.0
    for rec in records:
        rows, imgs, knn = _sample(rec, rec["meta"], rows_per_batch, rng, normalize)
        parts = {"x_id": [], "y_id": [], "roi_logit": [], "seg_logits": [], "x_logits": [],
                 "y_logits": []}
        ref.set_quant(ref_net, "fp8")
        try:
            with torch.no_grad():
                for a in range(0, len(rows), block):
                    sl = slice(a, a + block)
                    o = ref_net(imgs[sl], knn[sl] if knn.dim() == 3 else knn)
                    for k in parts:
                        parts[k].append(o[k])
        finally:
            ref.set_quant(ref_net, None)
        ctl = {k: torch.cat(v) for k, v in parts.items()}
        every = torch.arange(len(rows), device=rows.device)
        forced = {"x_id": ctl["x_id"], "y_id": ctl["y_id"], "roi": ctl["roi_logit"] > 0}
        judge.add(*served(ctl, every, channels),
                  *_both_references(ref_net, imgs, knn, forced, channels, block))
        # the decode one precision down: bfloat16 in place of float32
        bbox = rec["meta"]["bbox"].to(rows.device)[rows]
        S = 2 ** ctl["x_logits"].shape[-1]
        ids = torch.stack([ctl["x_id"], ctl["y_id"]], -1).to(torch.bfloat16)
        p2d = ids * (bbox[:, None, 2:4] / S).to(torch.bfloat16) + bbox[:, None, 0:2].to(
            torch.bfloat16)
        exact = ref_poses.decode(ctl["x_id"], ctl["y_id"], bbox, S)
        decode_px = max(decode_px, float((p2d.double() - exact).abs().amax()))
    return {**judge.numbers(), "decode_px_max": decode_px}
