"""Full-SNARK pipeline bench of the port (the counterpart of the
repository's ``scripts/bench_pipeline.py``): Compile -> Setup -> Solve and
Prove -> Verify of a ``GadgetCircuit`` over 2^log2_n hashes.

    python -m gkr_mimc_tpu_torch.bench_pipeline [log2_n=10] [--out PATH] [--device cpu]

The user circuit hashes 2^log2_n messages (the generator's stream) into
zero states with one ``update_hasher_batch``; the gadget's hash hint and
GKR prover hint run on the card, the rest on the host. Prints a line a
stage on stderr, then one JSON record on stdout: the constraint count,
constraints a hash, the 91 * N constraints of hashing directly in the
circuit (what the GKR gadget displaces), the wires and each stage's
seconds. ``--out`` also writes the record to PATH. It runs on the card;
the CPU only when asked for (``--device cpu`` or ``GKR_BENCH_DEVICE=cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import nullcontext

from .bench import build_kernels, log, resolve_device, sync
from .gadget import groth16
from .gadget import incircuit
from .utils.common import random_fr_array


def run(log2_n: int, dev, stage=nullcontext) -> dict:
    """The pipeline at 2^log2_n hashes on ``dev``: -> {"record", "circuit",
    "compiled", "pk", "vk", "proof", "public_values"}. groth16.verify
    raises if the proof does not verify. The setup is the reference's
    DummySetup analog (seed b"pipeline-bench"); the proof's blinding is
    fresh, as the reference's. Each stage runs inside ``stage(name)``
    (name "compile", "setup", "prove" or "verify"), a context manager a
    caller may use to label what runs inside it."""
    n = 1 << log2_n
    msgs = random_fr_array(n)

    def define(cs, gadget):
        states = [cs.witness(0) for _ in range(n)]
        gadget.update_hasher_batch(cs, states, [cs.witness(m) for m in msgs])

    circ = incircuit.GadgetCircuit(define, device=dev)
    with stage("compile"):
        t0 = time.perf_counter()
        compiled = circ.compile()
        t_compile = time.perf_counter() - t0
    r1cs = compiled.r1cs
    n_constraints = len(r1cs.constraints)
    log(f"compile: {t_compile:.3f} s, {n_constraints} constraints ({n_constraints / n:.1f}/hash vs "
        f"91*N={91 * n} direct), {r1cs.n_wires} wires, bn={compiled.bn}")

    with stage("setup"):
        t0 = time.perf_counter()
        pk, vk = incircuit.setup(compiled, seed=b"pipeline-bench")
        t_setup = time.perf_counter() - t0
    log(f"setup:   {t_setup:.3f} s")

    with stage("prove"):
        t0 = time.perf_counter()
        proof, public_values = circ.prove(compiled, pk, vk)
        sync(dev)
        t_prove = time.perf_counter() - t0
    log(f"prove:   {t_prove:.3f} s (solve trace + Groth16 MSMs/NTT)")

    with stage("verify"):
        t0 = time.perf_counter()
        groth16.verify(proof, vk, public_values)
        t_verify = time.perf_counter() - t0
    log(f"verify:  {t_verify:.3f} s OK")

    record = {"n_hashes": n, "constraints": n_constraints, "constraints_per_hash": round(n_constraints / n, 2),
              "direct_constraints_91N": 91 * n, "wires": r1cs.n_wires, "compile_s": t_compile,
              "setup_s": t_setup, "prove_s": t_prove, "verify_s": t_verify}
    return {"record": record, "circuit": circ, "compiled": compiled, "pk": pk, "vk": vk, "proof": proof,
            "public_values": public_values}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The Groth16 pipeline over 2^log2_n hashes: one JSON record on stdout.")
    ap.add_argument("log2_n", nargs="?", type=int, default=10)
    ap.add_argument("--out", help="also write the record here (JSON)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=os.environ.get("GKR_BENCH_DEVICE", "cuda"),
                    help="cuda (default) or cpu; the CPU only when asked for")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    build_kernels(dev)
    record = run(args.log2_n, dev)["record"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
