"""``--serve-demo``: fit a small pipeline, push synthetic traffic through
:class:`~keystone_tpu_torch.serving.engine.ServingEngine`, a
:class:`~keystone_tpu_torch.serving.fleet.ServingFleet` (``--replicas N``)
or the multi-process :class:`~keystone_tpu_torch.cluster.ClusterRouter`
(``--workers N`` or ``KEYSTONE_WORKERS``), and print the metrics (port of
``keystone_tpu/serving/demo.py``).

    python -m keystone_tpu_torch --serve-demo [--device cpu] [--requests 64] [--replicas N] [--workers N]

prints ``SERVE ok=N/N compiles=... aot_loads=... batches=... p50=... p99=...``
and ``SERVE PASS`` when every answer equals the fitted pipeline's own apply
and every bucket's program arrived once, traced or (with ``--aot-cache``)
loaded from the AOT cache. ``--expect-zero-compiles`` is the warm-boot
assertion: against a populated cache, the run fails unless warm-up paid
zero traces. With ``--replicas N`` the line adds ``replicas=... shed=...
steals=... per_replica_batches=...``, and the run passes when every bucket's
program arrived (``compiles + aot_loads`` at least the buckets: the
manifest's pre-warm may add more) and every replica ran a batch. With
``--workers N`` the line adds ``workers=... shed=... restarts=...
per_worker_batches=...`` (the JAX demo's line): every worker process
rebuilds the same pipeline from a factory on the demo's device and must
run a batch; ``--status`` prints the router's status view and
``--tenants name:weight,...`` spreads the traffic over weighted tenants.
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


def _serve_through_cluster(args, fitted, data, buckets, dev) -> int:
    """The ``--workers N`` path: a ClusterRouter over N worker processes,
    each rebuilding the same deterministic pipeline on the demo's device
    (the same fingerprint, so a warm boot from a shared AOT cache) and
    serving it from a local fleet of ``--replicas`` replicas."""
    from .. import compile as compile_mod
    from ..cluster import ClusterRouter, format_status

    tenant_weights = None
    if args.tenants:
        tenant_weights = {}
        for part in args.tenants.split(","):
            name, _, w = part.partition(":")
            tenant_weights[name.strip()] = float(w) if w else 1.0
    tenant_names = list(tenant_weights) if tenant_weights else None
    cache = compile_mod.get_cache()
    router = ClusterRouter(
        ("factory", "keystone_tpu_torch.cluster.demo:build_demo_model",
         {"num_ffts": args.numFFTs, "block_size": args.blockSize, "lam": args.lam,
          "n_train": args.nTrain}),
        workers=args.workers, device=str(dev), replicas_per_worker=max(1, args.replicas),
        buckets=buckets, datum_shape=data.shape[1:], max_queue=args.maxQueue,
        max_wait_ms=args.maxWaitMs, aot_cache=cache.root if cache is not None else None,
        tenant_weights=tenant_weights)
    router.install_signal_handlers()

    def _one(i_row):
        i, row = i_row
        tenant = tenant_names[i % len(tenant_names)] if tenant_names else None
        return router.submit(row, timeout=120.0, tenant=tenant).result()

    with router:
        with ThreadPoolExecutor(max_workers=args.clients) as pool:
            preds = list(pool.map(_one, enumerate(data)))
        snap = router.snapshot()
        reports = [r for r in router.worker_reports if r]
        if args.status:
            print(format_status(router.status(snap=snap)), flush=True)
    expected = (fitted.apply(torch.as_tensor(data, device=dev)).to_array().cpu().numpy()
                if len(data) else np.array([]))
    agree = int(np.sum(np.asarray(preds).ravel() == expected.ravel()))
    c, lat = snap["counters"], snap["latency"]
    compiles = sum(r.get("compiles", 0) for r in reports)
    aot_loads = sum(r.get("aot_loads", 0) for r in reports)
    worker_batches: dict = {}
    for key, row in snap.get("replicas", {}).items():
        w = key.split("/")[0]
        worker_batches[w] = worker_batches.get(w, 0) + row.get("batches", 0)
    print(f"SERVE ok={agree}/{len(data)} compiles={compiles} aot_loads={aot_loads} "
          f"batches={c.get('batches', 0)} completed={c.get('completed', 0)} "
          f"p50={lat.get('p50', 0):.4f}s p99={lat.get('p99', 0):.4f}s "
          f"workers={args.workers} shed={c.get('shed', 0)} restarts={c.get('restarts', 0)} "
          f"per_worker_batches={worker_batches}", flush=True)
    ok = agree == len(data) and c.get("completed", 0) == len(data)
    if len(reports) < args.workers:
        print(f"SERVE FAIL: only {len(reports)}/{args.workers} workers ready", flush=True)
        ok = False
    # the router spreads the load: every worker process ran a batch
    if len(worker_batches) < args.workers or any(b < 1 for b in worker_batches.values()):
        print(f"SERVE FAIL: idle worker (batches {worker_batches})", flush=True)
        ok = False
    if args.expect_zero_compiles and compiles != 0:
        print(f"SERVE FAIL: warm worker boots paid {compiles} trace(s), expected 0 (shared "
              "AOT cache and manifest)", flush=True)
        ok = False
    print("SERVE " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


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
                   help="N > 0: a ClusterRouter over N worker processes, each a local fleet of "
                        "--replicas replicas sharing the AOT cache directory; 0 (the default, "
                        "or KEYSTONE_WORKERS): in-process serving")
    p.add_argument("--buckets", default="8,32", help="comma-separated batch-size buckets")
    p.add_argument("--maxQueue", type=int, default=256)
    p.add_argument("--maxWaitMs", type=float, default=2.0)
    p.add_argument("--clients", type=int, default=8, help="concurrent submitter threads")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    p.add_argument("--status", action="store_true",
                   help="with --workers N: print the router's status view (per-process "
                        "timelines, worker liveness, SLO verdicts) after the traffic drains")
    p.add_argument("--tenants", default=None,
                   help="with --workers N: 'name:weight,...', weighted-fair tenant shares in "
                        "the worker fleets; the traffic round-robins the names")
    p.add_argument("--expect-zero-compiles", action="store_true", dest="expect_zero_compiles",
                   help="fail unless warm-up paid zero traces: the warm-boot assertion for a "
                        "populated AOT cache (--aot-cache / KEYSTONE_AOT_CACHE), where every "
                        "bucket must load its program")
    args = p.parse_args(argv)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    from .. import device as pick_device
    from .engine import ServingEngine
    from .fleet import ServingFleet

    dev = pick_device(args.device)
    fitted, test_data = build_demo_fitted(num_ffts=args.numFFTs, block_size=args.blockSize,
                                          lam=args.lam, n_train=args.nTrain,
                                          n_test=args.requests, device=dev)
    data = test_data[:args.requests]
    if args.workers > 0:
        return _serve_through_cluster(args, fitted, data, buckets, dev)
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
