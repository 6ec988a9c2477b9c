"""Traffic of kind ``batches``: one caller scores batches back to back
through a model fitted in set-up (``App.fit``, then ``App.apply``), the
``distinct`` batches of ``rows`` rows that the inputs drew from the seed, in
turn. Each batch's latency runs from its submission to its answer done on
the card, timed by CUDA events on the caller's stream (the host's clock on
the CPU). The window closes at the end of the first batch that ends past
its length.

Parameters read from the traffic file: ``rows``, ``distinct`` (read by the
inputs), ``warmup_passes`` (passes over the distinct batches in set-up, so
every shape is captured before the window)."""

from __future__ import annotations


def warm_up(app, inputs: dict, traffic: dict) -> None:
    app.fit()
    for _ in range(traffic["warmup_passes"]):
        for X in inputs["batches"]:
            app.apply(X)


def window(app, inputs: dict, traffic: dict, ctx, seconds: float, device, now) -> list:
    """Batches until ``seconds`` have passed; every (batch index, answer)."""
    import torch

    batches = inputs["batches"]
    timed = device.type == "cuda"
    answers = []
    w0 = now()
    while True:
        k = ctx.batches % len(batches)
        X = batches[k]
        if timed:
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            out = app.apply(X)
            end.record()
            end.synchronize()
            ctx.latencies_ms.append(begin.elapsed_time(end))
        else:
            t0 = now()
            out = app.apply(X)
            ctx.latencies_ms.append(1e3 * (now() - t0))
        answers.append((k, out))
        ctx.batches += 1
        ctx.rows += int(X.shape[0])
        if now() - w0 >= seconds:
            break
    ctx.window_s = now() - w0
    ctx.attempted = ctx.batches
    return answers


def model_flops(counts, cfg: dict, traffic: dict, ctx) -> float:
    return ctx.batches * counts.batch_flops(cfg, traffic["rows"])


def result_extras(ctx) -> dict:
    return {}
