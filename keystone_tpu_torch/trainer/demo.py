"""``--trainer-demo``: the closed continual-learning loop, end to end (port
of ``keystone_tpu/trainer/demo.py``).

    python -m keystone_tpu_torch --trainer-demo [--device cpu]

Boots a 2-replica :class:`~keystone_tpu_torch.serving.fleet.ServingFleet`
on a small deterministic regression pipeline, starts the
:class:`~keystone_tpu_torch.trainer.TrainerDaemon` against an append-only
:class:`~keystone_tpu_torch.trainer.ChunkLog`, and, while closed-loop
client threads hammer the fleet, appends good chunk batches (each must
pass its canary and promote a refreshed model) and one poisoned batch
(which must fail its canary, roll back and be parked). The demo exits
nonzero unless at least one refresh promoted, one rollback was clean, the
poisoned batch was parked, no request failed and no replica serves
another version. The data are the JAX demo's numpy draws, on the device
in float32; the device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import List, Optional

import numpy as np
import torch


def build_trainer_fitted(d: int = 16, k: int = 3, n_train: int = 512, chunk_rows: int = 64,
                         lam: float = 1e-2, device=None):
    """A deterministic absorbable pipeline: a tanh featurizer and a snapshot
    Gram solve, regression scores at the sink (not an argmax), so the
    canary's comparison measures how far a refreshed model moved: the whole
    promote-or-rollback signal. Returns ``(fitted, make, X0)`` with
    ``make(n, seed, shift=0.0)`` drawing host ``(X, Y)`` chunks."""
    from .. import device as pick_device
    from ..data.chunked import ChunkedDataset
    from ..data.dataset import Dataset
    from ..nodes.learning.linear import LinearMapEstimator
    from ..workflow.transformer import FunctionNode

    dev = pick_device(device)
    rng = np.random.RandomState(7)
    W_true = rng.randn(d, k).astype(np.float32)

    def make(n, seed, shift=0.0):
        r = np.random.RandomState(seed)
        X = (r.randn(n, d) + 1.0 + shift).astype(np.float32)
        Y = (np.tanh(X) @ W_true + 0.05 * r.randn(n, k)).astype(np.float32)
        return X, Y

    X0, Y0 = make(n_train, 0)
    fitted = (
        FunctionNode(batch_fn=torch.tanh, label="feat")
        .to_pipeline()
        .and_then(LinearMapEstimator(lam=lam, snapshot=True),
                  ChunkedDataset.from_array(torch.as_tensor(X0, device=dev), chunk_rows),
                  Dataset.of(torch.as_tensor(Y0, device=dev)))
        .fit()
    )
    return fitted, make, X0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("keystone-tpu-torch trainer-demo")
    p.add_argument("--nTrain", type=int, default=512)
    p.add_argument("--chunkRows", type=int, default=64)
    p.add_argument("--refreshes", type=int, default=2,
                   help="good chunk batches to append (each must promote)")
    p.add_argument("--chunksPerBatch", type=int, default=2)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--clients", type=int, default=4, help="closed-loop traffic threads")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="per-phase wait budget (seconds)")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    from ..serving import ServingFleet
    from . import ChunkLog, TrainerDaemon

    d = 16
    fitted, make, X0 = build_trainer_fitted(d=d, n_train=args.nTrain,
                                            chunk_rows=args.chunkRows, device=args.device)
    fleet = ServingFleet(fitted, replicas=args.replicas, buckets=(8,), datum_shape=(d,),
                         max_wait_ms=1.0, max_queue=1024)
    log = ChunkLog()
    stop = threading.Event()
    failures: List[str] = []

    def client(tid: int) -> None:
        i = tid
        while not stop.is_set():
            try:
                fleet.predict(X0[i % args.nTrain], timeout=15.0)
            except Exception as e:  # every failure is a gate violation
                failures.append(f"{type(e).__name__}: {e}")
            i += args.clients

    def wait_for(pred, what: str) -> bool:
        t0 = time.time()
        while time.time() - t0 < args.timeout:
            if pred():
                return True
            time.sleep(0.05)
        print(f"TRAINER FAIL: timed out waiting for {what}", flush=True)
        return False

    ok = True
    with fleet:
        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(args.clients)]
        for t in threads:
            t.start()
        daemon = TrainerDaemon(
            fleet, log, poll_interval_s=0.02, refit_interval_s=0.1,
            min_refit_chunks=args.chunksPerBatch, canary_fraction=1.0, canary_batches=2,
            canary_timeout_s=10.0, canary_atol=0.5, canary_rtol=0.5, max_batch_retries=0)
        with daemon:
            for b in range(args.refreshes):
                for j in range(args.chunksPerBatch):
                    X, Y = make(args.chunkRows, 100 + 10 * b + j)
                    log.append(X, Y)
                ok = ok and wait_for(
                    lambda want=b + 1: fleet.metrics.count("refits") >= want,
                    f"promoted refresh {b + 1}")
            # the poisoned batch: rows far off the distribution, whose
            # refit moves the model far outside the canary's tolerance
            for _ in range(args.chunksPerBatch):
                log.append(np.full((args.chunkRows, d), 1e4, np.float32),
                           np.full((args.chunkRows, 3), -1e4, np.float32))
            ok = ok and wait_for(
                lambda: fleet.metrics.count("rollbacks") >= 1 and daemon.parked_batches,
                "canary rollback + parked batch")
            parked = daemon.parked_batches
        stop.set()
        for t in threads:
            t.join(timeout=5)
        snap = fleet.metrics.snapshot()
        report = fleet.version_report()
    c = snap["counters"]
    lat = snap["latency"]
    print(f"TRAINER refits={c.get('refits', 0)} rollbacks={c.get('rollbacks', 0)} "
          f"parked={len(parked)} version={report['version']} skew={report['skew']} "
          f"completed={c.get('completed', 0)} failures={len(failures)} "
          f"p50={lat.get('p50', 0):.4f}s p99={lat.get('p99', 0):.4f}s", flush=True)
    if c.get("refits", 0) < max(1, args.refreshes):
        print("TRAINER FAIL: expected every good batch to promote", flush=True)
        ok = False
    if c.get("rollbacks", 0) < 1 or not parked:
        print("TRAINER FAIL: the poisoned batch must roll back and park", flush=True)
        ok = False
    if failures:
        print(f"TRAINER FAIL: {len(failures)} request failure(s), e.g. {failures[0]}",
              flush=True)
        ok = False
    if report["skew"]:
        print(f"TRAINER FAIL: replica version skew: {report}", flush=True)
        ok = False
    if c.get("completed", 0) != c.get("submitted", 0):
        print("TRAINER FAIL: submitted != completed", flush=True)
        ok = False
    print("TRAINER " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
