"""Compare checkouts of the PyTorch + CUDA port on one card, in turns.

    python3 scripts/torch_ab_trees.py [--bn 22] [--round-paths] ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example a parent commit unpacked
by ``git archive`` beside this one). For each ROOT, in the order given
(parent, change, change, parent puts drift on both sides), one fresh
process imports that checkout's ``chip_smoke.py`` and runs its phase 1
build, its phase 2 (every kernel against its plain twin at the main path's
shapes, timed with CUDA events beside its bound) and its phase 5 (the main
path at 2^bn hashes: witness, prove, verify, tamper probe, launch counts);
then a second process runs that checkout's
``scripts/torch_profile_layers.py bn`` (one cipher layer's wall time,
device time and busy share). Every line a child prints is passed on,
prefixed with ``[i ROOT]``. Between phases 2 and 5 it times ``mimc_hash``
at 1 and 9 words, whose slope is the hash chain's time an S-box. With
``--round-paths`` each child also runs that checkout's phase 7 right after
phase 5 (phase 5's witness proven again on the "coeff" and "evals" round
paths: prove times, equal proof vectors, launch counts). Needs a CUDA
device; exits non-zero if a child fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys, time
sys.path.insert(0, {root!r})
import torch
import chip_smoke as C
from gkr_mimc_tpu_torch.ops import build
dev = torch.device("cuda", 0)
card = C.card_line()
C.log(f"# card: {{card}}")
t0 = time.perf_counter()
build.library()
C.log(f"# kernels built in {{time.perf_counter() - t0:.1f}} s")
C.phase_kernels({bn}, dev)
# the hash chain's time an S-box: the slope of mimc_hash from 1 to 9 words
from gkr_mimc_tpu_torch.ops import kernels as K
import numpy as np
rng = np.random.default_rng(7)
ms = [C.time_kernel(K.mimc_hash, (C.rand_lazy(rng, (k,), dev),)) for k in (1, 9)]
C.log(f"# chain slope: mimc_hash K=1 {{ms[0]:.4f}} ms, K=9 {{ms[1]:.4f}} ms, "
      f"{{(ms[1] - ms[0]) * 1e6 / (8 * K.MIMC_ROUNDS):.1f}} ns an S-box")
main = C.phase_main({bn}, dev, card)
if {round_paths}:
    C.phase_round_paths_main({bn}, main, dev, card)
"""


def run(label: str, cmd: list, cwd: Path) -> None:
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        print(f"[{label}] {line}", end="", flush=True)
    if proc.wait() != 0:
        raise SystemExit(f"[{label}] {' '.join(cmd[:2])} exited with {proc.returncode}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bn", type=int, default=22, help="log2 of the hashes of the main path and the profiled layer")
    ap.add_argument("--round-paths", action="store_true",
                    help="also run phase 7 (the coeff and evals round paths) after phase 5")
    ap.add_argument("roots", nargs="+", help="checkout roots, run in this order")
    args = ap.parse_args()
    for i, root in enumerate(args.roots):
        root = Path(root).resolve()
        label = f"{i} {root.name}"
        run(label, [sys.executable, "-c", CHILD.format(root=str(root), bn=args.bn, round_paths=args.round_paths)],
            root)
        run(label, [sys.executable, str(root / "scripts" / "torch_profile_layers.py"), str(args.bn)], root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
