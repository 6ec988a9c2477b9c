"""Kernel K1's share of its roofline in the batch loop, in %: the least
time (``benchmark/counts/k1.py``) of the kernel blocks that scoring each
batch needs (one (rows, block, d) block per ``block_size`` training rows),
over every batch in the window, divided by K1's device time by kernel
name. The scores run as replays of captured CUDA graphs, which record no
host operator, so the shapes come from the model's definition."""

from benchmark.counts import k1

KERNELS = {"gaussian_block", "split_rows"}


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.batches:
        return None
    seconds = t.device_seconds(KERNELS)
    if seconds <= 0:
        return None
    cfg = ctx.config
    blocks = k1.mapper_launches(ctx.traffic["rows"], cfg["num_train"],
                                ctx.counts.feature_dim(cfg), cfg["block_size"])
    least = ctx.batches * sum(k1.least_seconds(*shape) for shape in blocks)
    return 100.0 * least / seconds
