"""Where the trainer's monitor spends a chunk's host moments.

One featurized chunk at the out-of-core TIMIT width (65,536 × 16,384
float32 on the card, 4.3 GB) is copied to the host and reduced to its
float64 column mean and M2 three ways: numpy's two passes over the whole
chunk (the JAX package's ``MomentsState.update``), torch CPU reductions in
float64, and the port's ``MomentsState.update`` (64-row float64 blocks on
up to 4 threads); the chunk's copies to pageable and to pinned host memory
are timed beside them. The host is otherwise idle here; ``chip_smoke.py``'s
``trainer_timit`` times the monitor under serving traffic.

    python3 tools/moments_split.py

Needs a CUDA card (exits 1 without one). Prints the card's name and power
limit, then one JSON line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS, WIDTH = 65536, 16384


def numpy_two_pass(host: np.ndarray):
    a = host.astype(np.float64)
    mean = a.mean(axis=0)
    return mean, ((a - mean) ** 2).sum(axis=0)


def torch_two_pass(host: torch.Tensor, block: int = 4096):
    mean = host.sum(dim=0, dtype=torch.float64) / host.shape[0]
    m2 = torch.zeros_like(mean)
    for i in range(0, host.shape[0], block):
        m2 += (host[i:i + block].double() - mean).square_().sum(dim=0)
    return mean, m2


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("moments_split: no CUDA device", file=sys.stderr)
        return 1
    from keystone_tpu_torch.linalg.accumulators import MomentsState

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    x = torch.randn(ROWS, WIDTH, device="cuda") + 1.0
    torch.cuda.synchronize()
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host = x.cpu()
    row = {"rows": ROWS, "width": WIDTH, "torch_threads": torch.get_num_threads(),
           "cpus": os.cpu_count(),
           "copy_pageable_s": timed(lambda: x.cpu()),
           "copy_pinned_s": timed(lambda: pinned.copy_(x)),
           "numpy_whole_chunk_s": timed(lambda: numpy_two_pass(host.numpy())),
           "torch_reductions_s": timed(lambda: torch_two_pass(host)),
           "port_update_from_host_s": timed(lambda: MomentsState().update(host)),
           "port_update_from_card_s": timed(lambda: MomentsState().update(x))}
    want = numpy_two_pass(host.numpy())
    got = MomentsState().update(x)
    row["port_rel_dev"] = max(float(np.max(np.abs(got.mean - want[0]) / np.abs(want[0]))),
                              float(np.max(np.abs(got.m2 - want[1]) / want[1])))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
