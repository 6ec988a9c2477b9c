"""The readings the limits of ``correct`` are set from: one process runs a
cell on many seeds, each from its own inputs, with a short window and no
warm-up, as the program states its precision (float32, TF32 off) or with a
control of ``benchmark/controls/`` switched on (``tf32``: the port's float32
products in TF32; ``k1_tf32``: K1's cross term in one TF32 pass), and
prints each seed's numbers, then each number's largest and smallest:

    python3 -m benchmark.calibrate --workload cifar_kernel.run --seeds 1-12 \\
        [--control tf32] [--seconds 0] [--out readings.jsonl]

Not part of a benchmark run; ``benchmark/tests/test_bench_cuda.py`` holds
the control to failing on the card."""

import argparse
import json
import sys


def seeds_of(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def calibrate(workload: str, seeds, control=None, seconds: float = 0.0, out=None) -> dict:
    from benchmark import harness

    readings = {}
    for seed in seeds:
        r = harness.run_cell(workload, seed, seconds, False, control=control, warmup=False)
        line = {"workload": workload, "seed": seed, "control": control,
                "correct": r["correct"], "run_seconds": r.get("run_seconds"),
                "numbers": {k: c["value"] for k, c in r["checks"].items()}}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
        for k, v in line["numbers"].items():
            readings.setdefault(k, []).append(v)
    summary = {k: {"max": max(v), "min": min(v)} for k, v in readings.items()}
    print(json.dumps({"workload": workload, "control": control, "summary": summary}), flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    calibrate(args.workload, seeds_of(args.seeds), args.control, args.seconds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
