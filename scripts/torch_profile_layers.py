"""Where one sumcheck layer of the PyTorch + CUDA port spends its time.

    python3 scripts/torch_profile_layers.py [bn]      (on a CUDA device; bn 22 by default)

Proves one cipher layer (single claim) on each head-round path (Gruen,
"coeff" and "evals") and the 91-claim identity layer of the MiMC circuit
at 2^bn instances, once unprofiled for
the wall time and once under torch.profiler. Prints per layer: wall ms,
device ms (the sum over CUDA kernel events only, so an aten op and the
kernel it launched count once), the device busy share, the number of
kernels launched, the port's own kernel time and launch counts, the
largest kernels and the most frequent host ops.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import prover as sp  # noqa: E402
from gkr_mimc_tpu_torch.utils.common import random_fr_array, random_fr_device  # noqa: E402
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows  # noqa: E402


def _is_kernel(event) -> bool:
    return str(event.device_type).endswith("CUDA")


def main() -> int:
    bn = int(sys.argv[1]) if len(sys.argv) > 1 else 22
    if not torch.cuda.is_available():
        print("torch_profile_layers: no CUDA device available", file=sys.stderr)
        return 1
    n, dev = 1 << bn, torch.device("cuda", 0)
    c = mimc_circuit()
    block = fr.to_mont(random_fr_device(n, 0, dev))
    a = assign_fused(block, block.clone())
    qps = ints_to_rows(random_fr_array(bn), dev)[None]
    qps91 = ints_to_rows([random_fr_array(bn + j)[j:] for j in range(91)], dev)
    claims91 = fr.encode_mont_ints(random_fr_array(91), dev)
    layers = {
        "cipher_layer": lambda: sp.prove([a[2], a[61]], qps, fr.encode_mont_ints([5], dev), c[60].gate),
        "cipher_layer coeff": lambda: sp.prove([a[2], a[61]], qps, fr.encode_mont_ints([5], dev), c[60].gate,
                                               rounds="coeff"),
        "cipher_layer evals": lambda: sp.prove([a[2], a[61]], qps, fr.encode_mont_ints([5], dev), c[60].gate,
                                               rounds="evals"),
        "identity_layer": lambda: sp.prove([a[0]], qps91, claims91, c[2].gate),
    }
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if _is_kernel(e)]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        port_ms = sum(e.self_device_time_total for e in kernels if "anonymous namespace" in e.key) / 1e3
        print(f"## {name} bn={bn}: wall {wall_ms:.1f} ms unprofiled; device {dev_ms:.1f} ms; "
              f"busy share {dev_ms / wall_ms:.3f}; kernels {sum(e.count for e in kernels)}; "
              f"port kernels {port_ms:.1f} ms; port launches {dict(K.LAUNCHES)}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"   {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.2f} ms  calls {e.count}")
        host = sorted((e for e in events if not _is_kernel(e)), key=lambda e: -e.count)[:6]
        print("   most frequent host ops: " + ", ".join(f"{e.key} x{e.count}" for e in host))
    return 0


if __name__ == "__main__":
    sys.exit(main())
