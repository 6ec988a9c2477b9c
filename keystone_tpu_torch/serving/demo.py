"""``--serve-demo``: fit a small pipeline, push synthetic traffic through
:class:`~keystone_tpu_torch.serving.engine.ServingEngine` (or, with
``--replicas N``, a :class:`~keystone_tpu_torch.serving.fleet.ServingFleet`)
and print the metrics (port of ``keystone_tpu/serving/demo.py``, its
in-process paths).

    python -m keystone_tpu_torch --serve-demo [--device cpu] [--requests 64] [--replicas N]

prints ``SERVE ok=N/N compiles=... aot_loads=... batches=... p50=... p99=...``
and ``SERVE PASS`` when every answer equals the fitted pipeline's own apply
and every bucket's program arrived once, traced or (with ``--aot-cache``)
loaded from the AOT cache. ``--expect-zero-compiles`` is the warm-boot
assertion: against a populated cache, the run fails unless warm-up paid
zero traces. With ``--replicas N`` the line adds ``replicas=... shed=...
steals=... per_replica_batches=...``, and the run passes when every bucket's
program arrived (``compiles + aot_loads`` at least the buckets: the
manifest's pre-warm may add more) and every replica ran a batch. The JAX
package's ``--workers N`` (a cluster) comes with ``cluster/``; here any
other value than 0 raises.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..utils import env_int


def build_demo_fitted(num_ffts: int = 2, block_size: int = 512, lam: float = 100.0,
                      n_train: int = 2048, n_test: int = 64, device=None):
    """The demo's serving pipeline: the synthetic MNIST task drawn on the
    device, the random-FFT featurizer, block least squares and argmax.
    Returns ``(fitted, test_data)``, the test rows as a host numpy array."""
    from ..nodes.learning.linear import BlockLeastSquaresEstimator
    from ..nodes.util import ClassLabelIndicators, MaxClassifier
    from ..pipelines.mnist_random_fft import (
        NUM_CLASSES,
        MnistRandomFFTConfig,
        build_featurizer,
        synthetic_mnist_device,
    )

    conf = MnistRandomFFTConfig(num_ffts=num_ffts, block_size=block_size, lam=lam)
    train, test = synthetic_mnist_device(n_train=n_train, n_test=max(n_test, 64),
                                         device=device)
    labels = ClassLabelIndicators(NUM_CLASSES).apply_batch(train.labels)
    fitted = (
        build_featurizer(conf, device)
        .and_then(BlockLeastSquaresEstimator(conf.block_size, 1, conf.lam or 0.0),
                  train.data, labels)
        .and_then(MaxClassifier())
        .fit()
    )
    return fitted, test.data.to_array().cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("keystone-tpu-torch serve-demo")
    p.add_argument("--numFFTs", type=int, default=2)
    p.add_argument("--blockSize", type=int, default=512)
    p.add_argument("--lambda", dest="lam", type=float, default=100.0)
    p.add_argument("--nTrain", type=int, default=2048)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--replicas", type=int, default=1,
                   help="1: the single-worker ServingEngine; N > 1: a ServingFleet of N "
                        "replicas (co-resident on one card)")
    p.add_argument("--workers", type=int, default=env_int("KEYSTONE_WORKERS", 0, minimum=0),
                   help="0: in-process serving (the multi-process cluster comes later)")
    p.add_argument("--buckets", default="8,32", help="comma-separated batch-size buckets")
    p.add_argument("--maxQueue", type=int, default=256)
    p.add_argument("--maxWaitMs", type=float, default=2.0)
    p.add_argument("--clients", type=int, default=8, help="concurrent submitter threads")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    p.add_argument("--expect-zero-compiles", action="store_true", dest="expect_zero_compiles",
                   help="fail unless warm-up paid zero traces: the warm-boot assertion for a "
                        "populated AOT cache (--aot-cache / KEYSTONE_AOT_CACHE), where every "
                        "bucket must load its program")
    args = p.parse_args(argv)
    if args.workers:
        raise SystemExit("--workers N serves from a multi-process ClusterRouter, which comes "
                         "with the cluster slice (cluster/); use --workers 0")
    buckets = tuple(int(b) for b in args.buckets.split(","))

    from .. import device as pick_device
    from .engine import ServingEngine
    from .fleet import ServingFleet

    dev = pick_device(args.device)
    fitted, test_data = build_demo_fitted(num_ffts=args.numFFTs, block_size=args.blockSize,
                                          lam=args.lam, n_train=args.nTrain,
                                          n_test=args.requests, device=dev)
    data = test_data[:args.requests]
    serve = ServingFleet if args.replicas > 1 else ServingEngine
    kwargs = {"replicas": args.replicas} if args.replicas > 1 else {}
    engine = serve(fitted, buckets=buckets, datum_shape=data.shape[1:],
                   max_queue=args.maxQueue, max_wait_ms=args.maxWaitMs, **kwargs)
    with engine:
        with ThreadPoolExecutor(max_workers=args.clients) as pool:
            preds = list(pool.map(lambda row: engine.predict(row, timeout=60.0), data))

    expected = (fitted.apply(torch.as_tensor(data, device=dev)).to_array().cpu().numpy()
                if len(data) else np.array([]))
    agree = int(np.sum(np.asarray(preds).ravel() == expected.ravel()))
    snap = engine.metrics.snapshot()
    c, lat = snap["counters"], snap["latency"]
    occ = snap["batch_occupancy"]["ratio"]
    compiles = c.get("compiles", 0)
    aot_loads = c.get("aot_loads", 0)
    per_replica = {idx: row["batches"] for idx, row in snap.get("replicas", {}).items()}
    print(f"SERVE ok={agree}/{len(data)} compiles={compiles} aot_loads={aot_loads} "
          f"batches={c.get('batches', 0)} completed={c.get('completed', 0)} "
          f"occupancy={'n/a' if occ is None else format(occ, '.3f')} "
          f"p50={lat.get('p50', 0):.4f}s p99={lat.get('p99', 0):.4f}s"
          + (f" replicas={args.replicas} shed={c.get('shed', 0)} steals={c.get('steals', 0)} "
             f"per_replica_batches={per_replica}" if args.replicas > 1 else ""), flush=True)
    ok = agree == len(data) and c.get("completed", 0) == len(data)
    n_buckets = len(engine.policy.batch_sizes)
    if args.replicas == 1:
        # every bucket's program arrived exactly once, traced or loaded from
        # the AOT cache (the policy keeps distinct sizes)
        ok = ok and compiles + aot_loads == n_buckets
    else:
        # one program a bucket, however many replicas; the manifest's
        # pre-warm may add signatures beyond the buckets
        ok = ok and compiles + aot_loads >= n_buckets
        # the fleet spreads the load: every replica ran a batch
        if len(per_replica) < args.replicas or any(b < 1 for b in per_replica.values()):
            print(f"SERVE FAIL: idle replica (batches {per_replica})", flush=True)
            ok = False
    if args.expect_zero_compiles and compiles != 0:
        print(f"SERVE FAIL: warm boot paid {compiles} trace(s), expected 0", flush=True)
        ok = False
    print("SERVE " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
