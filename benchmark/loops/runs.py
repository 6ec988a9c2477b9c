"""Traffic of kind ``runs``: whole application runs back to back, one
process, one caller. Each run starts from a fresh pipeline environment, as a
new process of the application would (``App.forget``), and calls the
application's own run function (``App.run``). The window closes at the end
of the first run that ends past its length.

Parameters read from the traffic file: ``warmup_runs``."""

from __future__ import annotations


def warm_up(app, inputs: dict, traffic: dict) -> None:
    for _ in range(traffic["warmup_runs"]):
        app.run()
        app.forget()


def window(app, inputs: dict, traffic: dict, ctx, seconds: float, device, now) -> list:
    """Runs until ``seconds`` have passed; no per-run answers (the App
    keeps what the last run produced)."""
    w0 = now()
    ctx.run_seconds = []
    while True:
        t0 = now()
        app.forget()
        app.run()
        ctx.run_seconds.append(now() - t0)
        ctx.runs += 1
        if now() - w0 >= seconds:
            break
    ctx.window_s = now() - w0
    ctx.attempted = ctx.runs
    return []


def model_flops(counts, cfg: dict, traffic: dict, ctx) -> float:
    return ctx.runs * counts.run_flops(cfg)


def result_extras(ctx) -> dict:
    """Keys the result line carries besides the required ones: each run's seconds."""
    return {"run_seconds": ctx.run_seconds}
