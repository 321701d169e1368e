"""One run of one cell: set-up, the measured window, the check.

Set-up loads the program (its kernel library is built once per checkout),
makes one warm-up proof at the cell's own shape from inputs no measured
proof uses, and makes the window's inputs ahead of it from (seed, proof
index): enough for one and a half times the proofs the warm-up's pace
gives, plus two. A proof past them makes its inputs in the window (the
same ones, from the same seed).

The window runs proofs back to back, each to its end, and starts a new
one only while less than ``seconds`` has passed. A proof is the program's
Montgomery conversion and witness, then its GKR walk, each span closed by
a device synchronisation. The witness is dropped before the next proof;
the output table (a copy) and the proof are kept for the check.

The check runs after the window has closed and the peak memory has been
read, on a sample of the window's proofs drawn from the seed: every layer
of each sampled proof through the plain verifier, and sampled entries of
its output table against MiMC-91 worked out again (``reference/``).
"""

from __future__ import annotations

import math
import os
import random
import time
from dataclasses import dataclass, field

import torch

from . import faults, rooflines, trace
from .inputs import ProofInputs
from .program import Prover
from .reference import verifier
from .spec import Cell, quantity, reader

WARMUP_PROOF = -1  # the proof index of the warm-up's inputs
MIN_CHECKED = 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem(device: torch.device, what: str) -> int:
    if device.type != "cuda":
        return 0
    return getattr(torch.cuda, what)(device)


@dataclass
class Window:
    proofs: list = field(default_factory=list)  # per proof: spans and the memory peak
    kept: list = field(default_factory=list)  # per proof: (inputs, output copy, proof)
    seconds: float = 0.0
    memory_peak_bytes: int = 0
    trace: dict | None = None


class Bench:
    """A cell set up on a device: the warm program and its traffic."""

    def __init__(self, cell: Cell, device: torch.device):
        self.cell, self.device = cell, device
        t = cell.traffic
        self.bn, self.lanes = int(t["bn"]), int(t.get("lanes", 1))
        if t["mode"] not in ("single", "grouped") or (t["mode"] == "grouped") != (self.lanes > 1):
            raise ValueError(f"traffic {cell.workload['traffic']}: mode {t['mode']!r} with {self.lanes} lanes")
        self.prover = Prover(cell.config, device)
        self.warmup_s = None

    def inputs(self, seed: int, proof: int) -> ProofInputs:
        return ProofInputs(seed, proof, self.bn, self.lanes, self.device)

    def one_proof(self, inputs: ProofInputs):
        """-> (output copy, proof, witness s, prove s, peak rise in bytes)."""
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        base = _mem(dev, "memory_allocated")
        t0 = time.perf_counter()
        wit, q = self.prover.witness(inputs)
        sync(dev)
        t1 = time.perf_counter()
        proof = self.prover.prove(wit, q)
        sync(dev)
        t2 = time.perf_counter()
        rise = _mem(dev, "max_memory_allocated") - base
        out = self.prover.output(wit)
        del wit
        return out, proof, t1 - t0, t2 - t1, rise

    def warm_up(self, seed: int) -> None:
        t0 = time.perf_counter()
        self.one_proof(self.inputs(seed, WARMUP_PROOF))
        self.warmup_s = time.perf_counter() - t0

    def pool(self, seed: int, seconds: float) -> list:
        count = math.ceil(3 * seconds / self.warmup_s) + 2
        pool = [self.inputs(seed, k) for k in range(count)]
        sync(self.device)
        return pool

    def window(self, seed: int, seconds: float, pool: list, traced: bool) -> Window:
        dev = self.device
        w = Window()
        sync(dev)
        w.memory_peak_bytes = _mem(dev, "max_memory_allocated")
        with trace.profiler(traced) as prof:
            with trace.window_range():
                start = time.perf_counter()
                k = 0
                while time.perf_counter() - start < seconds:
                    inputs = pool[k] if k < len(pool) else self.inputs(seed, k)
                    out, proof, wit_s, prove_s, rise = self.one_proof(inputs)
                    w.memory_peak_bytes = max(w.memory_peak_bytes, _mem(dev, "max_memory_allocated"))
                    w.proofs.append({"witness_s": wit_s, "prove_s": prove_s, "peak_above_start_bytes": rise})
                    w.kept.append((inputs, out, proof))
                    k += 1
                sync(dev)
                w.seconds = time.perf_counter() - start
        if traced:
            w.trace = trace.summarize(prof, len(w.proofs))
        return w

    def record(self, w: Window, inputs_bytes: int) -> dict:
        """What the per-layer readers read."""
        tail_bits = int(self.cell.config["tail_bits"])
        return {"bn": self.bn, "lanes": self.lanes, "hashes_per_proof": self.lanes << self.bn,
                "proofs": w.proofs, "inputs_bytes": inputs_bytes,
                "least_bytes_per_proof": rooflines.proof_bytes(self.bn, self.lanes, tail_bits),
                "hbm_bytes_per_s": rooflines.HBM_BYTES_PER_S, "trace": w.trace}


def check(bench: Bench, w: Window, seed: int, workers: int) -> dict:
    """Verify a sample of the window's proofs; frees the rest first.
    -> {"proofs_checked", "proof_failures", "hash_mismatches", "failed", "kinds", "check_s"}."""
    t0 = time.perf_counter()
    rng = random.Random(f"bench_h100:check:{seed}")
    chosen = sorted(rng.sample(range(len(w.kept)), min(len(w.kept), int(bench.cell.traffic["check_proofs"]))))
    kept = [w.kept[i] for i in chosen]
    w.kept.clear()
    if bench.device.type == "cuda":
        torch.cuda.empty_cache()
    total = bench.lanes << bench.bn
    samples = int(bench.cell.traffic["hash_samples"])
    res = {"proofs_checked": 0, "proof_failures": 0, "hash_mismatches": 0, "failed": 0, "kinds": {}}
    for inputs, out, proof in kept:
        arrays = bench.prover.proof_arrays(proof, bench.lanes)
        rep = verifier.check_proof(arrays, inputs.block, inputs.state, out, inputs.points, workers)
        cols = torch.tensor(sorted(rng.sample(range(total), min(total, samples))), device=out.device)
        bad = verifier.hash_mismatches(inputs.block, inputs.state, out, cols)
        res["proofs_checked"] += 1
        res["proof_failures"] += rep.total
        res["hash_mismatches"] += bad
        res["failed"] += int(rep.total > 0 or bad > 0)
        for kind, n in rep.failures.items():
            res["kinds"][kind] = res["kinds"].get(kind, 0) + n
    res["check_s"] = time.perf_counter() - t0
    return res


CHECKS = (  # (name, limit, passes(value)): each number compared and its limit
    ("proofs_checked", ">= 1", lambda v: v >= MIN_CHECKED),
    ("proof_failures", "0", lambda v: v == 0),
    ("hash_mismatches", "0", lambda v: v == 0),
)


def judged(res: dict) -> tuple[bool, dict]:
    numbers = {name: {"value": res[name], "limit": limit} for name, limit, _ in CHECKS}
    return all(ok(res[name]) for name, _, ok in CHECKS), numbers


def run(cell: Cell, device: torch.device, seed: int, seconds: float, traced: bool, t_start: float,
        log=print, fault: str | None = None) -> dict:
    """One run: -> the result's fields (without the device's name).
    ``fault`` plants one of ``faults.FAULTS`` under it (tests only)."""
    bench = Bench(cell, device)
    with faults.planted(fault, bench.prover):
        bench.warm_up(seed)
        pool = bench.pool(seed, seconds)
        inputs_bytes = pool[0].nbytes()
        setup_s = time.perf_counter() - t_start
        log(f"# set-up {setup_s:.3f} s (warm-up proof {bench.warmup_s:.3f} s, {len(pool)} proofs' inputs made)")
        w = bench.window(seed, seconds, pool, traced)
        del pool
    hashes = len(w.proofs) * (bench.lanes << bench.bn)
    rate = hashes / w.seconds
    log(f"# window {w.seconds:.3f} s: {len(w.proofs)} proofs, {hashes} hashes, {rate:.1f} hashes/s"
        f"{' (traced)' if traced else ''}; witness + prove s a proof: "
        + ", ".join(f"{p['witness_s']:.4f} + {p['prove_s']:.4f}" for p in w.proofs))
    record = bench.record(w, inputs_bytes)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"hashes_per_s": rate, "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[quantity(m["name"])], "unit": m["unit"]} for m in cell.end_to_end}
    out = {"attempted": len(w.proofs), "metrics": metrics, "memory_peak_bytes": w.memory_peak_bytes}
    if traced:
        busy = trace.busy_us(w.trace) / 1e6
        lo, hi = w.trace["window_us"]
        out.update(busy_s=busy, window_s=(hi - lo) / 1e6, breakdown=trace.breakdown(w.trace))
        w.trace = None
    del record
    workers = min(8, os.cpu_count() or 1)
    res = check(bench, w, seed, workers)
    log(f"# check {res['check_s']:.3f} s: {res['proofs_checked']} proofs, failures by kind {res['kinds']}")
    out["correct"], out["checks"] = judged(res)
    out["failed"] = res["failed"]
    return out
