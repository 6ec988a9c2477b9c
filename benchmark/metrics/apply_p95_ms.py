"""The 95th percentile of every batch's latency in the window: from its
submission to its scores done on the card, timed by CUDA events on the
caller's stream (the device's clock; the stream is idle at submission in a
closed loop, so the first event marks the submission)."""


def read(ctx):
    lat = sorted(ctx.latencies_ms)
    if not lat:
        return None
    pos = 0.95 * (len(lat) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(lat) - 1)
    return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)
