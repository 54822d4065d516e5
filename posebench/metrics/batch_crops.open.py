"""Mean real crops a serving call in the open loop (padding not counted)."""
import statistics


def read(ctx):
    sizes = ctx.counters.get("batch_crops")
    return statistics.fmean(sizes) if sizes else None
