"""The benchmark of the PyTorch and CUDA prover on the card: one cell, one run.

    python3 -m bench_h100.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (proofs started in the window), ``failed`` (sampled proofs
the check rejected), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; last, ``checks``: each number the check compared, with its
limit. Those numbers are also the last lines of standard error. The run
exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "bench_h100" / "_cache"  # fixed paths in the checkout: only a cell's first run fills them
FORBIDDEN = {"jax", "jaxlib", "flax", "gkr_mimc_tpu"}  # whole top-level module names


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_caches() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
        return res.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()

    from .spec import Cell, load

    try:
        cell = Cell(load(), args.workload)
    except (FileNotFoundError, KeyError) as e:
        log(f"bench_h100: {e}")
        return 2
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"bench_h100: the cell needs {chips} CUDA device(s); found {n}. No result.")
        return 2
    try:
        __import__("gkr_mimc_tpu_torch")
    except ImportError as e:
        log(f"bench_h100: the program under test is missing: {e}. No result.")
        return 2
    from . import cell as cell_run

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    log(f"# {args.workload} seed {args.seed} on {kind} ({power_limit()}), torch {torch.__version__}")
    out = cell_run.run(cell, device, args.seed, args.seconds, bool(args.trace), T_START, log)
    bad = forbidden_modules()
    if bad:
        log(f"bench_h100: the run loaded {bad}, which the port must never import. No result.")
        return 3
    dev = {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": dev}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
