"""MimcHash of many independent messages, spread over worker processes.

A proof's Fiat-Shamir challenges are independent hashes (one a round of a
layer, of that round's coefficients), some 18,000 to 66,000 MiMC
permutations a proof at the benchmark's sizes: a third of a millisecond
each on Python ints. They are hashed in ``workers`` child processes
(``python -m bench_h100.reference.hashing``), fed over pipes one message a
line, so nothing is shared but the pipes.

    python -m bench_h100.reference.hashing < messages > hashes
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .field import mimc_hash

ROOT = Path(__file__).resolve().parents[2]  # the directory that holds bench_h100/
IN_PROCESS = 512  # at most this many messages are hashed without workers


def hash_all(messages: list, workers: int) -> list[int]:
    """MimcHash of each message (a list of field ints), in order."""
    if workers <= 1 or len(messages) <= IN_PROCESS:
        return [mimc_hash(m) for m in messages]
    step = -(-len(messages) // workers)
    chunks = [messages[i : i + step] for i in range(0, len(messages), step)]
    with ThreadPoolExecutor(len(chunks)) as pool:
        parts = list(pool.map(_hash_in_child, chunks))
    return [h for part in parts for h in part]


def _hash_in_child(chunk: list) -> list[int]:
    text = "".join(",".join(map(str, m)) + "\n" for m in chunk)
    res = subprocess.run([sys.executable, "-m", "bench_h100.reference.hashing"], input=text, capture_output=True,
                         text=True, cwd=ROOT, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"hash worker failed ({res.returncode}): {res.stderr[-2000:]}")
    out = [int(v) for v in res.stdout.split()]
    if len(out) != len(chunk):
        raise RuntimeError(f"hash worker returned {len(out)} hashes for {len(chunk)} messages")
    return out


def main() -> int:
    out = []
    for line in sys.stdin:
        if line.strip():
            out.append(str(mimc_hash([int(v) for v in line.split(",")])))
    sys.stdout.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
