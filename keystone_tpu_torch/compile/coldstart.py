"""Cold-start probe: boot a serving engine against an AOT cache directory
and report what warm-up cost, as one JSON line on stdout (port of
``keystone_tpu/compile/coldstart.py``).

Run it in a fresh process twice against the same ``--cache`` directory:
the first boot exports and saves every bucket's program (cold), the second
must load every bucket and pay zero traces (warm). Everything
process-local that could mask the difference (the CUDA graphs, the
dispatcher's programs, the kernels' set-up) is fresh because the process
is.

The probe also checks the answers: the predictions served through the
(possibly loaded) engine must equal ``FittedPipeline.apply`` on the same
rows, or it exits 1. The fit is deterministic, so both processes fit the
same model and derive the same fingerprint; the fit is not what the probe
measures (``fit_seconds`` apart).

Usage::

    python -m keystone_tpu_torch.compile.coldstart --cache DIR [--buckets 8,32] [--device cpu]

Output (one line)::

    {"construct_seconds": ..., "warmup_seconds": ..., "compiles": N,
     "aot_loads": M, "captures": C, "buckets": [...], "outputs_match": true, ...}
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("keystone-tpu-torch coldstart probe")
    p.add_argument("--cache", required=True, help="AOT executable cache directory")
    p.add_argument("--buckets", default="8,32")
    p.add_argument("--numFFTs", type=int, default=2)
    p.add_argument("--blockSize", type=int, default=512)
    p.add_argument("--nTrain", type=int, default=512)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    t_proc0 = time.perf_counter()
    from ..utils.obs import configure

    configure(aot_cache=args.cache)

    import numpy as np
    import torch

    from .. import device as pick_device
    from ..serving.demo import build_demo_fitted
    from ..serving.engine import ServingEngine

    dev = pick_device(args.device)
    t0 = time.perf_counter()
    fitted, test_data = build_demo_fitted(num_ffts=args.numFFTs, block_size=args.blockSize,
                                          n_train=args.nTrain, n_test=args.requests,
                                          device=dev)
    fit_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine = ServingEngine(fitted, buckets=buckets)
    construct_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    warmed = engine.warm_up(required=True)
    warmup_seconds = time.perf_counter() - t0

    data = test_data[:args.requests]
    engine.start(warmup=False)  # already warm: not run (nor counted) again
    try:
        preds = [engine.predict(row, timeout=60.0) for row in data]
    finally:
        engine.shutdown()
    expected = fitted.apply(torch.as_tensor(data, device=dev)).to_array().cpu().numpy()
    outputs_match = bool(np.array_equal(np.asarray(preds).ravel(), expected.ravel()))

    counters = engine.metrics.snapshot()["counters"]
    print(json.dumps({
        "construct_seconds": round(construct_seconds, 4),
        "warmup_seconds": round(warmup_seconds, 4),
        "fit_seconds": round(fit_seconds, 4),
        "buckets_warmed": warmed,
        "buckets": list(engine.policy.batch_sizes),
        "compiles": counters.get("compiles", 0),
        "aot_loads": counters.get("aot_loads", 0),
        "captures": engine._compiled.captures,
        "device": str(dev),
        "requests": len(data),
        "outputs_match": outputs_match,
        "process_seconds": round(time.perf_counter() - t_proc0, 4),
    }), flush=True)
    return 0 if outputs_match else 1


if __name__ == "__main__":
    raise SystemExit(main())
