"""Where an identity round's time goes on the card, pass by pass.

    python3 scripts/torch_identity_passes.py [--bn 22]      (on a CUDA device)

Times ``ops.kernels.identity_acc`` and ``identity_partial_evals`` (t = 1, 2)
on random tables made from a numpy seed, at n = 2^bn (G = 1) and at
G = 4 x 2^(bn-2): each call with CUDA events (the mean of 50 calls after a
warm-up, three times), then the device time of each kernel that one call
launches (torch.profiler over 20 calls of ``identity_acc``: the scratch's
memset, pass 1, pass 2), beside the byte bound (eq and x read once at
3.35 TB/s). Each output is held equal to its plain twin first. It runs on
any checkout of the port, so two trees can be compared in one call. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gkr_mimc_tpu_torch.fields.bn254 import L  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402

TWO_P_TOP = 0x60C89CE5  # top limb of 2p: limbs below it give values < 2p
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory (NVIDIA's data sheet)


def rand_lazy(rng, n: int, dev) -> torch.Tensor:
    limbs = rng.integers(0, 1 << 32, size=(L, n), dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


def time_ms(fn, args, reps: int = 50) -> float:
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def per_kernel_us(fn, args, calls: int = 20) -> dict:
    """Device us a call of each kernel that ``fn`` launches."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / calls for ev in prof.key_averages() if ev.device_time_total > 0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bn", type=int, default=22)
    bn = ap.parse_args().bn
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(22)
    n = 1 << bn
    eq, x = rand_lazy(rng, n, dev), rand_lazy(rng, n, dev)
    bound_ms = 2 * n * 32 / HBM_BYTES_PER_S * 1e3
    for g in (1, 4):
        cases = {"identity_acc": (eq, x, g), "identity_partial_evals": (eq, x, g, K.IDENTITY_EVALS, True)}
        for name, args in cases.items():
            if not torch.equal(getattr(K, name)(*args), K.PLAIN[name](*args)):
                raise AssertionError(f"{name}: kernel != plain at G = {g}")
            ms = [time_ms(getattr(K, name), args) for _ in range(3)]
            print(f"{name} G = {g} x 2^{bn - (g > 1) * 2}: {' '.join(f'{t:.4f}' for t in ms)} ms; bound "
                  f"{bound_ms:.4f} ms (bytes), share {bound_ms / min(ms):.3f}", flush=True)
        for key, us in per_kernel_us(K.identity_acc, cases["identity_acc"]).items():
            print(f"  identity_acc G = {g}, a call: {us:.1f} us {key}", flush=True)


if __name__ == "__main__":
    main()
