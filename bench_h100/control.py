"""The check's readings at a cell's own size, on many seeds in one process.

    python3 -m bench_h100.control --workload <name> --seconds <s> --seeds <n> ... \
        [--faults none skip_last_round ...] [--fault-seeds 3]

Sets the cell up once (kernels, warm-up), then for each fault (``none`` is
the program as it is; the others are ``faults.FAULTS``, ``skip_last_round``
the control) and each seed runs a short window of the cell's own traffic
and the run's check, and prints one JSON line: the numbers compared, the
failures by kind, the proofs and the check's seconds. The benchmark's own
runs never run this. It needs a CUDA device, as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import cell as C
from .faults import FAULTS, planted
from .spec import Cell, load


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["none"], choices=("none",) + FAULTS)
    ap.add_argument("--fault-seeds", type=int, default=3, help="seeds a planted fault runs on (the first ones)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_h100.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = C.Bench(Cell(load(), args.workload), dev)
    bench.warm_up(args.seeds[0])
    print(f"# {args.workload} on {torch.cuda.get_device_name(dev)}: warm-up {bench.warmup_s:.3f} s",
          file=sys.stderr, flush=True)
    workers = min(8, os.cpu_count() or 1)
    for fault in args.faults:
        seeds = args.seeds if fault == "none" else args.seeds[: args.fault_seeds]
        for seed in seeds:
            with planted(None if fault == "none" else fault, bench.prover):
                pool = bench.pool(seed, args.seconds)
                w = bench.window(seed, args.seconds, pool, False)
                del pool
            hashes = len(w.proofs) * (bench.lanes << bench.bn)
            t0 = time.perf_counter()
            res = C.check(bench, w, seed, workers)
            ok, numbers = C.judged(res)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed, "proofs": len(w.proofs),
                              "hashes_per_s": hashes / w.seconds, "correct": ok,
                              "numbers": {k: v["value"] for k, v in numbers.items()}, "kinds": res["kinds"],
                              "check_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
