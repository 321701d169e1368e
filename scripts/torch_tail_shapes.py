"""Time one layer's tail rounds on the card, eagerly and in one launch.

    python3 scripts/torch_tail_shapes.py [--m 256]      (on a CUDA device)

A layer of the MiMC walk at tail_bits 8 ends in log2(m) tail rounds on
tables of m = 2^8 entries. This script times, on random tables made from
a numpy seed (one lane):

1. ``ops.kernels.cipher_layer`` at the shapes the eager tail rounds give
   it: (8, 9 x 2^j) points for j = log2(m) - 1 down to 0, CUDA events,
   each shape and their sum over one tail;
2. the eager tail of a cipher and of an identity layer: log2(m) calls of
   ``sumcheck.prover._generic_round`` (stack_t, the gate, the eq-weighted
   sums, interpolation, the ``mimc_hash`` challenge, the folds), wall ms
   beside the device ms, busy share and kernel count that torch.profiler
   reads;
3. where the checkout has ``ops.kernels.tail_rounds``: the same tails in
   one launch each (CUDA events; held bit-equal to the eager tail's
   coefficients, challenges and final values), beside the chain floor,
   log2(m) x ``mimc_hash``'s time at E words (E = 9 cipher, 3 identity).

It runs on any checkout of the port (parts 1 and 2 on one without
``tail_rounds`` too), so two trees can be compared in one call. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gkr_mimc_tpu_torch.circuits.gates import CipherGate, IdentityGate  # noqa: E402
from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.fields.bn254 import L  # noqa: E402
from gkr_mimc_tpu_torch.hashes.ark import ARKS_INT  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import prover as sp  # noqa: E402

TWO_P_TOP = 0x60C89CE5  # top limb of 2p: limbs below it give values < 2p


def sync() -> None:
    torch.cuda.synchronize()


def rand_lazy(rng, shape, dev) -> torch.Tensor:
    limbs = rng.integers(0, 1 << 32, size=(L,) + tuple(shape), dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


def event_ms(fn, reps: int = 10) -> float:
    """ms a call, CUDA events over reps calls after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def eager_tail(gate, eq, xs):
    """The tail as the eager rounds run it: (coeffs, rs, finals) stacked as
    tail_rounds returns them."""
    params = gate.params(eq.device)
    coeffs, rs = [], []
    while eq.shape[-1] > 1:
        eq, xs, c, r = sp._generic_round(gate, params, eq, xs)
        coeffs.append(c)
        rs.append(r)
    return torch.stack(coeffs), torch.stack(rs), torch.stack([eq[:, :, 0]] + [x[:, :, 0] for x in xs])


def profiled(fn):
    """(device ms, kernels) of one call under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    return sum(e.self_device_time_total for e in kernels) / 1e3, sum(e.count for e in kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=256, help="entries of a table when the tail starts")
    m = ap.parse_args().m
    if not torch.cuda.is_available():
        print("torch_tail_shapes: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    rng = np.random.default_rng(2024)
    s = m.bit_length() - 1
    ark = fr.from_int_mont(ARKS_INT[5], dev)

    total = 0.0
    for j in range(s - 1, -1, -1):
        n = 9 * (1 << j)
        l, r = rand_lazy(rng, (n,), dev), rand_lazy(rng, (n,), dev)
        ms = event_ms(lambda: K.cipher_layer(l, r, ark))
        total += ms
        print(f"# cipher_layer (8, {n}) = 9 x 2^{j} points: {ms:.4f} ms", flush=True)
    print(f"# cipher_layer over one tail (m = {m}, {s} launches): {total:.4f} ms", flush=True)

    has_kernel = hasattr(K, "tail_rounds")
    gates = {"cipher": (CipherGate(ARKS_INT[5]), 2, 9), "identity": (IdentityGate(), 1, 3)}
    for name, (gate, k, n_evals) in gates.items():
        eq = rand_lazy(rng, (1, m), dev)
        xs = [rand_lazy(rng, (1, m), dev) for _ in range(k)]
        eager = lambda: eager_tail(gate, eq, xs)  # noqa: E731
        want = eager()
        sync()
        t0 = time.perf_counter()
        eager()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        dev_ms, kernels = profiled(eager)
        print(f"# eager {name} tail, m = {m}: wall {wall:.3f} ms, device {dev_ms:.3f} ms, busy share "
              f"{dev_ms / wall:.3f}, kernels {kernels}", flush=True)
        if not has_kernel:
            continue
        ark_arg = gate.params(dev)[0] if k == 2 else None
        fused = lambda: K.tail_rounds(eq, xs, ark_arg)  # noqa: E731
        got = fused()
        sync()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: tail_rounds differs from the eager tail")
        ms = event_ms(fused, reps=5)
        words = rand_lazy(rng, (n_evals,), dev)
        hash_ms = event_ms(lambda: K.mimc_hash(words))
        sync()
        t0 = time.perf_counter()
        fused()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        dev_ms, kernels = profiled(fused)
        print(f"# tail_rounds {name}, m = {m}: {ms:.4f} ms (CUDA events), wall {wall:.3f} ms, device "
              f"{dev_ms:.3f} ms, kernels {kernels}; equal to the eager tail; chain floor {s} x mimc_hash "
              f"({n_evals} words, {hash_ms:.4f} ms) = {s * hash_ms:.4f} ms, {ms / (s * hash_ms):.3f}x it",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
