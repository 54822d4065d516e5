"""Percent of the bf16 EdgeConv kernels' roofline a forward: the least time of
the forward's launches (bytes over HBM rate or products over the bf16 peak,
whichever is larger, plus the max over K at the f32 rate) over the device
time of the kernels named `edgeconv_tc` in the trace of one synchronous
batch (one forward)."""
from posebench import trace as tr


def bound_s(B, N, K, C, Cp):
    """Least seconds of one launch: bytes (x, both weight halves, knn,
    scale and bias read once, out written once) over the HBM rate, or the
    two per-node products over the bf16 peak, or one compare per edge and
    channel over the f32 rate, whichever is largest."""
    nbytes = 2 * (B * N * C + 2 * C * Cp + B * N * Cp) + 4 * N * K + 8 * Cp
    return max(nbytes / tr.PEAK_BYTES_S, 4.0 * B * N * C * Cp / tr.PEAK_BF16_S,
               1.0 * B * N * K * Cp / tr.PEAK_F32_S)


def read(ctx):
    t, c = ctx.launch_trace, ctx.counters
    if t is None or not t.units or "edgeconv_shapes" not in c:
        return None
    dev = sum(e - s for name, s, e in t.kernels() if "edgeconv_tc" in name)
    per_forward = c.get("edgeconv_launches_per_batch", {}).get("tc", 0)
    if dev <= 0 or per_forward != len(c["edgeconv_shapes"]):
        return None
    N, K = c["npoint"], c["knn_k"]
    bound = sum(bound_s(B, N, K, C, Cp) for B, C, Cp in c["edgeconv_shapes"])
    return 100.0 * bound / (dev / t.units)
