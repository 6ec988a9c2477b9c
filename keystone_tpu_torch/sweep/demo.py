"""``--sweep-demo``: fit a λ grid as one merged DAG, absorb appended rows
into one member, and hot-swap it into a live serving engine (port of
``keystone_tpu/sweep/demo.py``).

    python -m keystone_tpu_torch --sweep-demo [--device cpu] [--grid 1e-2,1e-1]

Its gates are work counts: the shared featurize prefix runs once at full
size across the whole grid, every λ solves from the one shared Gram
accumulation, absorb folds only the appended rows, and no request fails
across the swap. The data are the JAX demo's numpy draws (seed 0), put on
the device in float32.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..workflow.transformer import Transformer


class CountingFeaturize(Transformer):
    """tanh(X R)·2, counting its full-size executions: the optimizer's
    sampled pulls run on a few rows and do not count."""

    # the counter is a write to self, which the static checker's lattice
    # marks stateful (a capture would freeze it); it counts eager runs
    # only, and the served chain is otherwise pure: the verdict is pinned
    check_verdict = "traceable"

    def __init__(self, R: torch.Tensor, full_rows: int):
        self.R = R
        self.full_rows = int(full_rows)
        self.full_calls = 0

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        if int(X.shape[0]) == self.full_rows:
            self.full_calls += 1
        return torch.tanh(X @ self.R) * 2.0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("keystone-tpu-torch sweep-demo")
    p.add_argument("--grid", default="1e-3,1e-2,1e-1,1.0", help="comma-separated λ values")
    p.add_argument("--nTrain", type=int, default=2048)
    p.add_argument("--nAppend", type=int, default=256)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    lams = [float(s) for s in args.grid.split(",")]
    n, d, k = args.nTrain, args.dim, args.classes

    from .. import device as pick_device
    from ..data.dataset import Dataset
    from ..nodes.learning.linear import LinearMapEstimator
    from ..serving import ServingEngine
    from .grid import GridSweep

    dev = pick_device(args.device)
    rng = np.random.default_rng(0)
    R = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
    X = rng.standard_normal((n, d)).astype(np.float32) + 0.5
    W_true = rng.standard_normal((d, k)).astype(np.float32)
    Y = ((np.tanh(X @ R) * 2.0) @ W_true
         + 0.05 * rng.standard_normal((n, k)).astype(np.float32)).astype(np.float32)

    def on_device(a):
        return torch.as_tensor(a, device=dev)

    feat = CountingFeaturize(on_device(R.astype(np.float32)), n)
    res = GridSweep(feat.to_pipeline(), lambda lam: LinearMapEstimator(lam=lam), {"lam": lams},
                    Dataset.of(on_device(X)), Dataset.of(on_device(Y))).fit()
    prefix_once = feat.full_calls == 1
    gram_reuse = res.stats["gram_reuse_solves"] == len(lams)
    print(f"SWEEP members={len(res)} prefix_full_executions={feat.full_calls} "
          f"gram_reuse_solves={res.stats['gram_reuse_solves']} "
          f"groups={res.stats['groups']}", flush=True)

    # incremental refit, then publish
    best = res.fitted_for(lam=lams[len(lams) // 2])
    Xn = rng.standard_normal((args.nAppend, d)).astype(np.float32) + 0.5
    Yn = ((np.tanh(Xn @ R) * 2.0) @ W_true
          + 0.05 * rng.standard_normal((args.nAppend, k)).astype(np.float32)).astype(np.float32)
    updated = best.absorb(Dataset.of(on_device(Xn)), Dataset.of(on_device(Yn)))
    state = updated.graph.get_operator(updated.absorbable_nodes()[0]).solver_state
    absorb_ok = state.n == n + args.nAppend
    print(f"ABSORB appended={args.nAppend} total_rows={state.n} ok={absorb_ok}", flush=True)

    engine = ServingEngine(best, buckets=(8,), datum_shape=(d,), max_wait_ms=2.0)
    with engine:
        pre = [engine.predict(x, timeout=60.0) for x in X[: args.requests // 2]]
        warmed = engine.swap(updated)
        post = [engine.predict(x, timeout=60.0) for x in X[: args.requests // 2]]
    c = engine.metrics.snapshot()["counters"]
    served = len(pre) + len(post)
    swap_ok = (c.get("swaps", 0) == 1 and c.get("failed", 0) == 0
               and c.get("completed", 0) == served and warmed >= 1)
    # the swap changed the served model
    moved = float(np.max(np.abs(np.asarray(pre[0]) - np.asarray(post[0]))))
    print(f"SWAP buckets_warmed={warmed} served={served} "
          f"completed={c.get('completed', 0)} failed={c.get('failed', 0)} "
          f"model_moved={moved:.2e}", flush=True)
    ok = prefix_once and gram_reuse and absorb_ok and swap_ok
    print("SWEEP " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
