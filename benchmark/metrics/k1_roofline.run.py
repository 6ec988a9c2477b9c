"""Kernel K1's share of its roofline in the runs, in %: over every launch
in the window, the sum of its least time (``benchmark/counts/k1.py``, from
the shape the host operator ``keystone::gaussian_kernel_block`` recorded),
divided by K1's device time by kernel name. Nothing is read where the
launches are not all eager operators (one recorded shape a main kernel)."""

from benchmark.counts import k1

OP = "keystone::gaussian_kernel_block"
MAIN = {"gaussian_block"}
KERNELS = MAIN | {"split_rows"}


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ops = t.ops(OP)
    seconds = t.device_seconds(KERNELS)
    if not ops or seconds <= 0 or len(ops) != t.launches(MAIN):
        return None
    least = 0.0
    for op in ops:
        (n, d), (b, _) = op["args"]["Input Dims"][:2]
        least += k1.least_seconds(n, b, d)
    return 100.0 * least / seconds
