"""End-to-end GKR-MiMC prover benchmark of the port (the counterpart of the
repository's ``bench.py``).

    python -m gkr_mimc_tpu_torch.bench [--device cpu]

Measures MiMC hashes proven per second: deterministic inputs generated on
the device (the reference's RandomFrArray stream) -> witness -> the
94-layer GKR proof -> verification. Prints ONE JSON line on stdout,
``{"metric", "value", "unit", "vs_baseline"}``, and only after the proofs
verified (the verifier raises otherwise); stage lines go to stderr.

It runs on the card. The CPU is used only when asked for (``--device
cpu`` or ``GKR_BENCH_DEVICE=cpu``); with no card and no such request it
exits non-zero.

Environment, as ``bench.py`` reads it:

* ``GKR_BENCH_BN``: log2 of the hashes a proof (23 on the card, 8 on the CPU);
* ``GKR_BENCH_VERIFY``: "0" skips verification (default "1");
* ``GKR_BENCH_SHARDED=1``: the sharded walk over the ranks of the job,
  world size 1 in this process unless it was started as one rank of
  several (torchrun's variables, as ``parallel.multihost.initialize``
  reads them);
* ``GKR_BENCH_GROUP=G`` (G > 1): G proofs walked together;
* ``GKR_BENCH_TOTAL_LOG2=T`` (T > bn): 2^T hashes as verified 2^bn chunks;
* ``GKR_BENCH_CKPT``: the checkpointed witness, on by default at bn >= 21
  in the single mode and always in the grouped mode;
* ``GKR_BASELINE_HASHES``: the baseline (300,000 hashes/s, ``bench.py``'s
  documented model of a 64-core EPYC running the reference).

The modes are checked in that order (sharded, grouped, chunked, single).
The single mode on the card also prints the layer report: one Gruen
cipher layer's ms, the Fiat-Shamir µs a hash and the layer's roofline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

from .fields import fr
from .gkr import prover as gkr_prover
from .gkr import verifier as gkr_verifier
from .models.checkpoint import CheckpointedAssignment
from .models.mimc import assign_fused, mimc_circuit
from .utils.common import grouped_inputs, random_fr_array, random_fr_device
from .utils.convert import ints_to_rows

EPYC_BASELINE_HASHES_PER_SEC = float(os.environ.get("GKR_BASELINE_HASHES", 300_000.0))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
FE = 32  # bytes a field element: eight 32-bit limbs
FS_CHAIN = 40  # dependent transcript hashes timed by the layer report


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resolve_device(name: str) -> torch.device:
    """"cpu" only when asked for; "cuda" needs a card and never falls back."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise SystemExit(f"unknown device {name!r}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available: pass --device cpu (or set GKR_BENCH_DEVICE=cpu) "
                         "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def build_kernels(dev: torch.device) -> None:
    """Build (or load) the CUDA kernels once, before anything is timed."""
    if dev.type != "cuda":
        return
    from .ops import build

    t0 = time.perf_counter()
    build.library()
    log(f"# kernels built (first call, ops.build.library()): {time.perf_counter() - t0:.1f} s -> "
        f"{build.library_path().name}")


@dataclass
class Run:
    """One mode's timed run. ``hashes`` / ``seconds`` is the metric's
    value; the other fields are what the caller may check further: the
    circuit, inputs, witness, proof and, for the chunked mode, the
    sampled columns of every chunk's output with its block and state
    offsets."""

    metric: str
    hashes: int
    seconds: float
    times: dict
    verified: int = 0
    circuit: object = None
    block: torch.Tensor | None = None
    state: torch.Tensor | None = None
    qprime: torch.Tensor | None = None
    witness: object = None
    proof: object = None
    outputs: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    @property
    def hps(self) -> float:
        return self.hashes / self.seconds

    def record(self) -> dict:
        return {"metric": self.metric, "value": round(self.hps, 1), "unit": "hashes/s",
                "vs_baseline": round(self.hps / EPYC_BASELINE_HASHES_PER_SEC, 3)}


def main_inputs(bn: int, dev: torch.device):
    """The main path's inputs: block = state = the stream at 0 (Montgomery
    form, separate buffers), qprime = random_fr_array(bn)."""
    block = fr.to_mont(random_fr_device(1 << bn, 0, dev))
    return block, block.clone(), ints_to_rows(random_fr_array(bn), dev)


def chunk_inputs(ci: int, chunks: int, bn: int, dev: torch.device):
    """Chunk ci of a 2^T stream proven as 2^bn chunks: its block is the
    stream at ci * 2^bn, its state the stream at (chunks + ci) * 2^bn."""
    n = 1 << bn
    return (fr.to_mont(random_fr_device(n, ci * n, dev)),
            fr.to_mont(random_fr_device(n, (chunks + ci) * n, dev)))


def _timed_walk(c, block, state, qprime, dev, ckpt: bool) -> tuple:
    """Witness (resident or checkpointed) and proof, each synchronised:
    -> (witness, proof, witness s, prove s)."""
    sync(dev)
    t0 = time.perf_counter()
    a = CheckpointedAssignment(block, state) if ckpt else assign_fused(block, state)
    sync(dev)
    t1 = time.perf_counter()
    proof = gkr_prover.prove(c, a, qprime)
    sync(dev)
    return a, proof, t1 - t0, time.perf_counter() - t1


def _walk_run(metric: str, make_inputs, dev, ckpt: bool, warmup: bool) -> Run:
    """Inputs on the device (timed), one warm-up walk (dropped before the
    timed one) if asked, then the timed witness + prove."""
    c = mimc_circuit()
    sync(dev)
    t0 = time.perf_counter()
    block, state, qprime = make_inputs()
    sync(dev)
    times = {"inputs_s": time.perf_counter() - t0}
    if warmup:
        t0 = time.perf_counter()
        _timed_walk(c, block, state, qprime, dev, ckpt)
        times["warmup_s"] = time.perf_counter() - t0
        log(f"# warmup: {times['warmup_s']:.2f} s")
    a, proof, times["witness_s"], times["prove_s"] = _timed_walk(c, block, state, qprime, dev, ckpt)
    run = Run(metric, block[0].numel(), times["witness_s"] + times["prove_s"], times, circuit=c, block=block,
              state=state, qprime=qprime, witness=a, proof=proof)
    log(f"# prove {metric} ({'checkpointed' if ckpt else 'resident'} witness): witness "
        f"{times['witness_s'] * 1e3:.1f} ms + prove {times['prove_s'] * 1e3:.1f} ms -> {run.hps:,.0f} hashes/s")
    return run


def _timed_verify(run: Run, key: str, verify, dev) -> None:
    """``verify`` (the verifier raises) of the run's proof, timed into
    run.times[key]."""
    t0 = time.perf_counter()
    verify(run.circuit, run.proof, [run.block, run.state], run.witness[93], run.qprime)
    sync(dev)
    run.times[key] = time.perf_counter() - t0
    log(f"# {key[:-2].replace('_', ' ')}: {run.times[key]:.3f} s OK")


def single(bn: int, dev: torch.device, ckpt: bool, verify: bool = True, warmup: bool = True) -> Run:
    """bench.py's single mode: one proof of 2^bn hashes (witness + prove
    timed), after one warm-up run; verified twice (cold, hot)."""
    run = _walk_run(f"mimc_hashes_proven_per_sec_bn{bn}", lambda: main_inputs(bn, dev), dev, ckpt, warmup)
    if verify:
        for key in ("verify_cold_s", "verify_hot_s"):
            _timed_verify(run, key, gkr_verifier.verify, dev)
            run.verified += 1
    return run


def grouped(bn: int, g: int, dev: torch.device, ckpt: bool = True, verify: bool = True,
            warmup: bool = True) -> Run:
    """bench.py's grouped mode: G proofs of 2^bn hashes in one walk (lane i
    the stream at i * 2^bn and (G + i) * 2^bn), witness + prove timed after
    a warm-up run, then verify_grouped."""
    run = _walk_run(f"mimc_hashes_proven_per_sec_grouped_bn{bn}_g{g}", lambda: grouped_inputs(bn, g, dev), dev,
                    ckpt, warmup)
    if verify:
        _timed_verify(run, "verify_s", gkr_verifier.verify_grouped, dev)
        run.verified = g
    return run


def sharded(bn: int, dev: torch.device, verify: bool = True, warmup: bool = True) -> Run:
    """bench.py's sharded mode: the sharded "coeff" walk over the ranks of
    the job, each rank building its slab of the main path's inputs; a
    warm-up prove, then the timed prove. World size 1 in this process
    unless the process was started as one rank of several. The tables are
    gathered and the proof verified on rank 0; the returned block, state
    and witness output are the whole tables there. The ranks talk over
    nccl on the card, gloo on the CPU."""
    import torch.distributed as dist

    from .parallel import mesh as pmesh
    from .parallel import multihost

    backend = "nccl" if dev.type == "cuda" else "gloo"
    created = not dist.is_initialized()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        multihost.initialize(backend=backend)
    else:
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend=backend)
    try:
        m = multihost.make_global_mesh(device=dev.type, backend=backend)
        c = mimc_circuit()
        n = 1 << bn
        sync(m.device)
        t0 = time.perf_counter()
        block = multihost.shard_mimc_inputs_global(m, n)
        state = block.clone()
        qprime = ints_to_rows(random_fr_array(bn), m.device)
        sync(m.device)
        t1 = time.perf_counter()
        a = pmesh.assign_sharded_mimc(block, state)
        sync(m.device)
        times = {"inputs_s": t1 - t0, "witness_s": time.perf_counter() - t1}
        if warmup:
            t0 = time.perf_counter()
            pmesh.prove_gkr_sharded(c, a, qprime, m)
            sync(m.device)
            times["warmup_s"] = time.perf_counter() - t0
            log(f"# sharded warmup: {times['warmup_s']:.2f} s")
        m.counts.update(all_reduce=0, all_gather=0)
        t0 = time.perf_counter()
        proof = pmesh.prove_gkr_sharded(c, a, qprime, m)
        sync(m.device)
        times["prove_s"] = time.perf_counter() - t0
        collectives = dict(m.counts)
        run = Run(f"mimc_hashes_proven_per_sec_sharded_bn{bn}_d{m.size}", n, times["prove_s"], times, circuit=c,
                  qprime=qprime, witness=a, proof=proof,
                  extra={"rank": m.rank, "world": m.size, "backend": m.backend, "device": str(m.device),
                         "collectives": collectives})
        log(f"# sharded prove bn={bn} D={m.size} (rank {m.rank}, {m.backend}, {m.device}): {times['prove_s']:.3f} s "
            f"-> {run.hps:,.0f} hashes/s; {collectives['all_reduce']} all-reduces, "
            f"{collectives['all_gather']} all-gathers")
        if verify:
            run.block, run.state, out = (pmesh.unshard_table(pmesh.all_gather_slab(t, m)) for t in (block, state, a[93]))
            run.extra["output"] = out
            if m.rank == 0:
                t0 = time.perf_counter()
                gkr_verifier.verify(c, proof, [run.block, run.state], out, qprime)
                sync(m.device)
                times["verify_s"] = time.perf_counter() - t0
                run.verified = 1
                log(f"# sharded verify (rank 0, gathered tables): {times['verify_s']:.3f} s OK")
        return run
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def chunked(bn: int, total_log2: int, dev: torch.device, verify: bool = True, warmup: bool = True,
            sample=None) -> Run:
    """bench.py's chunked mode: 2^total_log2 hashes as 2^(total_log2 - bn)
    proofs of 2^bn hashes from one input stream (``chunk_inputs``), each
    with the resident witness and one qprime for all; a warm-up proof of
    chunk 0, then the timed loop.

    Chunk k+1 is dispatched before chunk k is verified, as in the
    reference, but on one CUDA stream chunk k's check queues behind chunk
    k+1's proof, so the loop runs serially (a check on a worker thread
    and a second stream ran no faster on the card: the checks are host
    work). A chunk keeps its block, state, proof and a copy of its output
    table past its proof, not its witness (the tables are views of one
    tensor), so at most one witness is on the device at a time.
    ``sample``, a list of instances, keeps those columns of each chunk's
    output in run.outputs as (block offset, state offset, columns)."""
    n, chunks = 1 << bn, 1 << (total_log2 - bn)
    c = mimc_circuit()
    qprime = ints_to_rows(random_fr_array(bn), dev)

    def prove_chunk(ci):
        block, state = chunk_inputs(ci, chunks, bn, dev)
        a = assign_fused(block, state)
        return ci, block, state, a[93].clone(), gkr_prover.prove(c, a, qprime)

    times = {}
    if warmup:
        sync(dev)
        t0 = time.perf_counter()
        prove_chunk(0)
        sync(dev)
        times["warmup_s"] = time.perf_counter() - t0
        log(f"# warmup: {times['warmup_s']:.2f} s")

    outputs = []
    verified = 0
    sync(dev)
    t0 = time.perf_counter()
    prev = prove_chunk(0)
    for ci in range(1, chunks + 1):
        nxt = prove_chunk(ci) if ci < chunks else None  # dispatched before chunk ci - 1 is verified
        k, block, state, out, proof = prev
        if verify:
            gkr_verifier.verify(c, proof, [block, state], out, qprime)
            verified += 1
        if sample is not None:
            outputs.append((k * n, (chunks + k) * n, out[:, sample]))
        prev = nxt
    sync(dev)
    times["loop_s"] = time.perf_counter() - t0
    run = Run(f"mimc_hashes_proven_per_sec_total2e{total_log2}_bn{bn}", chunks * n, times["loop_s"], times,
              verified=verified, circuit=c, qprime=qprime, outputs=outputs)
    log(f"# chunked prove 2^{total_log2} = {chunks} x 2^{bn}: {times['loop_s']:.3f} s -> {run.hps:,.0f} hashes/s "
        f"({verified}/{chunks} chunks verified)")
    return run


def layer_report(bn: int, dev: torch.device) -> dict:
    """bench.py's per-layer report on the card: one Gruen cipher layer
    through the production sumcheck path at 2^bn, timed with CUDA events
    over 6 layers after a warm-up; the Fiat-Shamir µs a hash from a chain
    of FS_CHAIN dependent 9-word transcript hashes; the layer's roofline in
    the card's terms (32 B an element, 3.35 TB/s): the round kernel reads
    S, x0 and x1 and writes the folded halves, and the halving rounds sum
    to ~2x round 1. The hash chain (bn x the measured µs a hash) is the
    protocol's latency floor on top."""
    from .circuits.gates import CipherGate
    from .hashes.mimc import mimc_hash_device
    from .sumcheck import prover as sp

    n = 1 << bn
    x0 = fr.to_mont(random_fr_device(n, 0, dev))
    x1 = fr.to_mont(random_fr_device(n, n, dev))
    gate = CipherGate(145646)
    qprimes = ints_to_rows(random_fr_array(bn + 1)[1:], dev)[None]
    claims = fr.encode_mont_ints([5], dev)

    def layer():
        return sp.prove([x0, x1], qprimes, claims, gate)

    def event_ms(fn, reps: int) -> float:
        fn()  # warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    layer_ms = event_ms(layer, 6)
    msgs = fr.encode_mont_ints(list(range(1, 10)), dev)  # (8, 9)

    def chain():
        m = msgs
        for _ in range(FS_CHAIN):
            m = mimc_hash_device(m)[:, None].expand(-1, 9)
        return m

    fs_us = event_ms(chain, 3) / FS_CHAIN * 1e3
    hbm_ms = 2 * (3.5 + 1) * (n // 2) * FE / HBM_BYTES_PER_S * 1e3
    fs_ms = bn * fs_us / 1e3
    rep = {"bn": bn, "layer_ms": layer_ms, "hbm_ms": hbm_ms, "fs_hash_us": fs_us, "fs_chain_ms": fs_ms,
           "gap": layer_ms / (hbm_ms + fs_ms)}
    log(f"# per-layer (cipher sumcheck, bn={bn}): {layer_ms:.2f} ms | rooflines: HBM {hbm_ms:.3f} ms "
        f"(32 B an element at 3.35 TB/s) + FS-chain floor {fs_ms:.2f} ms ({fs_us:.1f} us/hash measured, "
        f"{FS_CHAIN} dependent hashes) (compute-bound gap: {rep['gap']:.2f}x)")
    return rep


def mode_of(bn: int, env) -> str:
    """The mode bench.py's dispatch picks (bench.py:392-403)."""
    if env.get("GKR_BENCH_SHARDED") == "1":
        return "sharded"
    if int(env.get("GKR_BENCH_GROUP", "0")) > 1:
        return "grouped"
    if int(env.get("GKR_BENCH_TOTAL_LOG2", "0")) > bn:
        return "chunked"
    return "single"


def main(argv=None) -> int:
    env = os.environ
    ap = argparse.ArgumentParser(description="GKR-MiMC prover benchmark of the port: one JSON line on stdout.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=env.get("GKR_BENCH_DEVICE", "cuda"),
                    help="cuda (default) or cpu; the CPU only when asked for")
    dev = resolve_device(ap.parse_args(argv).device)
    on_card = dev.type == "cuda"
    bn = int(env.get("GKR_BENCH_BN", 23 if on_card else 8))
    verify = env.get("GKR_BENCH_VERIFY", "1") == "1"
    build_kernels(dev)
    mode = mode_of(bn, env)
    if mode == "sharded":
        run = sharded(bn, dev, verify)
        if run.extra["rank"] != 0:
            return 0
    elif mode == "grouped":
        run = grouped(bn, int(env["GKR_BENCH_GROUP"]), dev, env.get("GKR_BENCH_CKPT", "1") == "1", verify)
    elif mode == "chunked":
        run = chunked(bn, int(env["GKR_BENCH_TOTAL_LOG2"]), dev, verify)
    else:
        ckpt = env.get("GKR_BENCH_CKPT", "1" if bn >= 21 else "0") == "1"
        run = single(bn, dev, ckpt, verify)
        if on_card:
            layer_report(bn, dev)
    print(json.dumps(run.record()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
