"""Smoke run of the PyTorch + CUDA port (gkr_mimc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--bn 22]

Builds the CUDA kernels from gkr_mimc_tpu_torch/csrc at first use (one
nvcc per source, in parallel) and, beside them, the gadget's host runtime
(native/bn254.cpp, one g++), then:

1. toolchain and card: torch, CUDA, nvcc, the card's name and power limit,
   the build time and nvcc's register report, with a summary line of the
   registers, spills and shared memory of the deferred round kernels (the
   cipher rounds' pass 1 on one and two weight rows, the identity rounds'
   pass 1, their three finishers) and the hash-chain kernels (the tail
   rounds' two gates among them);
2. every kernel against its plain torch twin on the card, bit for bit, at
   small shapes (G = 1, 2, 4; both claim-trick settings of the partial
   evaluations; the fold at 3 tables; multi_eq at one claim; the S-boxes,
   the three cipher rounds and the two identity rounds at the lazy
   representatives' edges; the five deferred rounds where a block sums more
   points than one flush interval of their digit sums; the tail rounds of
   both gates at G = 1 and 4, at the
   main path's 2^8 entries, a single round, the largest tail and the lazy
   edges) and
   at the main path's shapes (timed, kernel and plain, beside the least
   time the card could take for the same work), some also at a second
   shape; the hash chain's ns a product, and the tail rounds' chain floor
   (log2(m) hashes of their coefficients);
3. golden transcripts: MimcHash([12]) and tests/golden/transcripts.json,
   with tail_bits 8 and 1;
4. a full GKR walk at bn = 13 (its single-claim eq tables, 2^13 entries,
   take multi_eq's hi/lo contraction) and a grouped walk of G = 2
   instances at bn = 10, each through the kernels and again through the
   plain twins on the same CUDA tensors: identical proof vectors; each
   grouped lane
   equals the single-instance walk of its inputs. Then the two other round
   paths, rounds="coeff" and rounds="evals", at tail_bits 2: a walk at
   bn = 10 (its eq tables built through mul_scalar) equal to the default
   "gruen" walk, and G = 2 lanes at bn = 8 each equal to the gruen walk
   of its inputs;
5. the main path at --bn (default 22, the north-star size): inputs
   generated on the card, witness, GKR proof, verification, a tamper probe,
   and the launch count of every kernel during that run;
7. (run right after phase 5, while its witness is resident) phase 5's
   inputs and witness proven again on the "coeff" and the "evals" round
   paths: each proof verifies, rejects the tamper probe and has phase 5's
   proof vector; prove time and the launch counts of each run;
6. the grouped path, G = 4 instances at bn = --bn - 2 (as many hashes as
   the main path): inputs on the card, witness, grouped proof,
   verify_grouped, a tamper probe in lane 2 that must be named, and the
   launch counts of that run;
8. the other circuits: GMiMC T2 (96 layers) at bn = --bn - 2 and Poseidon
   T2 (RF 8, RP 82: 397 layers) at bn = --bn - 8, each through the generic
   witness (circuits.assign), proof, verification, a tamper probe and its
   output table against the host permutation at 257 sampled instances,
   timed per layer kind; a GMiMC T2 and a Poseidon (2, 2, 3) walk at
   bn = 10 through the kernels and again through the plain twins
   (identical proof vectors); GMiMC's full-state prover at bn = 10; and
   the six GMiMC and Poseidon device hashers over 2^16 messages against
   the host hash;
9. the probes (gkr_mimc_tpu_torch.ops.probes, the counterparts of the
   TPU package's micro-benchmark scripts): each probe kernel against its
   plain version at a few hundred elements (bit for bit; the f32 body of
   op_chain to 1e-5 relative), then the five scripts' counterparts at
   their default shapes through the probes' entry points, each timed case
   held to its plain version before it is timed with CUDA events: 32-bit
   op rates and the tensor-core dot on wgmma (beside torch._int_mm(m, x)
   * reps, the same function, and torch._int_mm at equal work, cuBLAS's
   int8 rate), imma_dot at IMMA_MAX_REPS on the extreme inputs,
   check_mxu_mul's field check of both multiplies, the Montgomery-product
   split, the S-box chain latency in both layouts (each at the lazy edges
   and at rounds and 2 rounds first) beside the transcript hash chain's,
   the partial-evals multiply A/B;
10. the standalone gadget at bn = --bn - 4 (2^18 hashes at the default,
   the low end of the reference's gadget benchmark range): the native host
   runtime built, 2^bn - 3 updates through ``update_hasher_batch`` (the
   first 2^16 public), ``make_setup``, ``close(check=True)`` (pad, commit
   with the split G1 MSM, rho, witness, prove, self-verify, serialize) and
   ``verify_gadget``, each stage timed; the wire vector's size and its
   ``proof_from_vec`` round trip, three tamper probes (rho, the first
   proof element, a private output), the batch's new states against the
   host update at 257 instances, the launch counts of that run against the
   expected ones; then one gadget's close() at bn = 10 through the kernels
   and again through the plain twins: the same proof;
11. the Groth16 pipeline at bN = 2 (the shape of the JAX package's
   test_gadget_pipeline_batched_hasher; the reference benchmarks
   2^18-2^24 hashes, cut by the host's pure-Python tracer): GadgetCircuit
   over 4 messages hashed by one ``update_hasher_batch`` (the hash hint
   and the GKR prover hint on the card, all else on the host),
   ``compile()`` (the R1CS sizes logged), ``setup(seed)``,
   ``prove(seed)`` and ``groth16.verify``, each stage timed (solve's and
   compile's card parts, the in-circuit verifier, computeH, the MSMs);
   three tamper probes (KrsGkrPriv, the first public value, Ar) that must
   raise Groth16VerifyError; the solve trace's GKR inputs proven again
   through the plain twins (the same proof vector); the run's launch
   counts, every kernel, against the expected ones;
12. (run after phase 7, while phase 5's proof vector is held) the sharded
   walk (gkr_mimc_tpu_torch.parallel, rounds="coeff") at --bn: (a) world
   size 1 on nccl in this process, the rank's slab of the inputs from
   ``shard_mimc_inputs_global``, ``assign_sharded_mimc``,
   ``prove_gkr_sharded``, verified with the unsharded tables, a tamper
   probe, phase 5's proof vector, the run's launch counts against the
   schedule; (b) two ranks started by this script on the one card, gloo
   (nccl refuses two ranks on one device), each building only its slab of
   phase 5's inputs: rank 0's proof vector is phase 5's, each rank's
   times, collectives, launch counts and exit code logged; a rank that
   fails or outlives its time limit fails the phase with its output;
13. the checkpointed witness (``models.checkpoint.CheckpointedAssignment``,
   stride 13) on the default path, each stage under
   ``utils.profiling.Timer``: (a) at --bn, phase 5's proof vector, its peak
   memory beside phase 5's; (b) at --bn + 3 (2^25 hashes at the default,
   whose resident witness would need 101 GB): inputs on the card, witness,
   prove, verify, a tamper probe, the outputs against the host permutation,
   hashes/s, peak memory, the launch counts (``mimc_witness`` once per span
   and again per span but the last); (c) ``profile_trace`` around a
   bn = 12 walk: the Chrome trace holds kernel events of the port's
   kernels.

Each path's launch counts are read from its own run, the counts set to 0
just before it: the kernels of the default path from phase 5,
cipher_coeff_acc from phase 7's coeff run, the partial evaluations from
its evals run, mul_scalar (which builds single-claim eq tables below
2^13 entries only) from phase 4's coeff walk at bn = 10, pow7 (the
hashers' S-box) and cipher_layer (the generic witness's cipher layers;
the MiMC walk runs its tails, gate included, in tail_rounds) from phase
8, and the six probes from phase 9's run of the scripts' counterparts.
Phases 10-13 log their counts on lines of their own, not in the kernels
line.

Prints one JSON line of per-kernel results, then the nvidia-smi line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero on any
failure, including when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gkr_mimc_tpu_torch.circuits.circuit import assign  # noqa: E402
from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.fields.bn254 import L, P  # noqa: E402
from gkr_mimc_tpu_torch import native  # noqa: E402
from gkr_mimc_tpu_torch.gadget import GadgetVerifyError, GkrGadget, proof_from_vec, proof_size, verify_gadget  # noqa: E402
from gkr_mimc_tpu_torch.gadget import GadgetCircuit  # noqa: E402
from gkr_mimc_tpu_torch.gadget import bn254_g1 as g1  # noqa: E402
from gkr_mimc_tpu_torch.gadget import gadget as gadget_mod  # noqa: E402
from gkr_mimc_tpu_torch.gadget import groth16 as groth16_mod  # noqa: E402
from gkr_mimc_tpu_torch.gadget import incircuit as incircuit_mod  # noqa: E402
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec  # noqa: E402
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover  # noqa: E402
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier  # noqa: E402
from gkr_mimc_tpu_torch.hashes import gmimc as gmimc_hash  # noqa: E402
from gkr_mimc_tpu_torch.hashes import poseidon as poseidon_hash  # noqa: E402
from gkr_mimc_tpu_torch.hashes.ark import arks_mont  # noqa: E402
from gkr_mimc_tpu_torch.hashes.mimc import mimc_hash, mimc_hash_device, mimc_keyed_permutation, mimc_update  # noqa: E402
from gkr_mimc_tpu_torch.models import gmimc, poseidon  # noqa: E402
from gkr_mimc_tpu_torch.models.checkpoint import CheckpointedAssignment  # noqa: E402
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit  # noqa: E402
from gkr_mimc_tpu_torch.ops import build  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402
from gkr_mimc_tpu_torch.ops import probes as Pr  # noqa: E402
from gkr_mimc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gkr_mimc_tpu_torch.parallel import multihost  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import prover as sumcheck_prover  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import testing  # noqa: E402
from gkr_mimc_tpu_torch.utils.common import grouped_inputs, random_fr_array, random_fr_device  # noqa: E402
from gkr_mimc_tpu_torch.utils import profiling  # noqa: E402
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints  # noqa: E402

MIMC_KAT = 1808205620575546259657963589762746470347087906694759866517376279978241663265
TWO_P_TOP = 0x60C89CE5  # top limb of 2p: limbs below it give values < 2p
GROUPS = 4  # lanes of the grouped path (phase 6)

# Least-time bounds (H100 SXM at its 700 W limit): device memory at
# 3.35 TB/s (NVIDIA's data sheet), and 32-bit integer multiply results at
# 132 SMs x 64 per clock x 1.98 GHz. A CIOS Montgomery product of 8-limb
# operands is 64 + 64 widening 32 x 32 -> 64 products (two 32-bit results
# each) and 8 single ones: 264 results.
HBM_BYTES_PER_S = Pr.HBM_BYTES_PER_S  # 3.35e12
INT_MULS_PER_S = Pr.INT_RESULTS_PER_S  # 132 * 64 * 1.98e9
MULS_PER_PRODUCT = Pr.MULS_PER_PRODUCT  # 264
FE = 32  # bytes per field element
# The cipher rounds' deferred algorithm (csrc/round_acc.cu, namespace
# deferred): 9 full products and 8 unreduced ones (64 widening products,
# 128 32-bit results) a point, and a 32 x 512 byte-digit contraction on the
# tensor cores a weight row (one for gruen_acc, two for the direct rounds).
# The identity rounds' (same namespace): no product a point, a 32 x 64
# byte-digit contraction (x at the bottom and the top) a weight row (eq at
# the bottom and the top), one product to Montgomery form a coefficient.
DEFERRED_FULL, DEFERRED_WIDE, WIDE_RESULTS, DEFERRED_MACS = 9, 8, 128, 32 * 512
IDENTITY_MACS = 32 * 64
WEIGHT_ROWS = {"gruen_acc": 1, "cipher_coeff_acc": 2, "cipher_partial_evals": 2, "identity_acc": 2,
               "identity_partial_evals": 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# kernels whose registers, spills and shared memory phase 1 logs by name
# (parts of their mangled names): the deferred rounds' two passes 1 (the
# cipher rounds' in both instantiations, the identity rounds') and their
# finishers, and the hash-chain kernels (the tail rounds' both gates among
# them)
PASS1_WATCH = ("8deferred10acc_kernel", "8deferred19identity_acc_kernel")
REGISTER_WATCH = PASS1_WATCH + ("8deferred19gruen_finish_kernel", "8deferred19coeff_finish_kernel",
                                "8deferred22identity_finish_kernel", "gruen_round_kernel", "mimc_hash_kernel",
                                "tail_kernel", "imma_dot_kernel", "sbox_col_kernel", "sbox_row_kernel")


def ptxas_usage(text: str) -> dict:
    """nvcc -Xptxas -v report -> {kernel: {registers, spill_stores,
    spill_loads, smem}} (bytes; smem static only)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur["registers"], cur["smem"] = int(m.group(1)), int(smem.group(1)) if smem else 0
    return out


def log_sass() -> None:
    """The watched kernels as ptxas compiled them (cuobjdump -sass of the
    built library): instructions in all and in the largest loop (pass 1's
    tile loop; the hash chain's round loop, one S-box), and the tensor-core
    (IMMA, and GMMA for warpgroup wgmma) and shuffle instructions of the
    loop. Fails if an instantiation of a deferred pass 1 has no IMMA in its
    tile loop, or the imma_dot probe no GMMA in its loop."""
    for fn, (loop, whole) in Pr.sass_loops_of_library().items():
        if not any(key in fn for key in REGISTER_WATCH):
            continue
        imma = sum(op.startswith("IMMA") for op in loop)
        gmma = sum("GMMA" in op for op in loop)
        shfl = sum(op.startswith("SHFL") for op in loop)
        log(f"# sass {fn}: {len(whole)} instructions, largest loop {len(loop)} ({imma} IMMA, {gmma} GMMA, "
            f"{shfl} SHFL)")
        if any(key in fn for key in PASS1_WATCH) and imma == 0:
            raise AssertionError(f"{fn}: no IMMA in its tile loop")
        if "imma_dot_kernel" in fn and gmma == 0:
            raise AssertionError(f"{fn}: no warpgroup GMMA in its loop")


def sync() -> None:
    torch.cuda.synchronize()


def rand_lazy(rng: np.random.Generator, shape, dev) -> torch.Tensor:
    """Field tables of lazy representatives (< 2p) from a numpy seed."""
    limbs = rng.integers(0, 1 << 32, size=(L,) + tuple(shape), dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


# held integers at the edges of the lazy range [0, 2p)
LAZY_EDGES = Pr.LAZY_EDGES


def edge_table(values, dev) -> torch.Tensor:
    """An (8, n) table holding the given integers (< 2p) as they are."""
    raw = b"".join(int(x).to_bytes(4 * L, "little") for x in values)
    limbs = np.frombuffer(raw, dtype="<u4").reshape(len(values), L).T.copy()
    return torch.from_numpy(limbs.view(np.int32)).to(dev)


def max_abs_err(a, b) -> int:
    """Largest limb difference (unsigned 32-bit values) over all outputs."""
    outs_a = list(a) if isinstance(a, (list, tuple)) else [a]
    outs_b = list(b) if isinstance(b, (list, tuple)) else [b]
    if len(outs_a) != len(outs_b):
        raise AssertionError(f"{len(outs_a)} outputs vs {len(outs_b)}")
    err = 0
    for x, y in zip(outs_a, outs_b):
        if x.shape != y.shape:
            raise AssertionError(f"shapes {tuple(x.shape)} vs {tuple(y.shape)}")
        if torch.equal(x, y):
            continue
        xf, yf = x.reshape(-1), y.reshape(-1)
        for i in range(0, xf.numel(), 1 << 24):  # int64 copies of a slice at a time
            d = (xf[i : i + (1 << 24)].to(torch.int64) & 0xFFFFFFFF) - (yf[i : i + (1 << 24)].to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max().item()))
    return err


def time_kernel(fn, args) -> float:
    """ms per call, CUDA events over repeated launches after a warm-up."""
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    sync()
    reps = max(1, min(20, int(200.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def time_once(fn, args):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    out = fn(*args)
    end.record()
    sync()
    return out, start.elapsed_time(end)


@contextmanager
def plain_twins():
    """Swap every kernel wrapper for its plain twin (callers resolve
    K.<name> at call time), so the same CUDA tensors take the plain path."""
    saved = {name: getattr(K, name) for name in K.KERNELS}
    for name in K.KERNELS:
        setattr(K, name, K.PLAIN[name])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def kernel_cases(bn: int, dev, rng):
    """(kernel name, small cases, main-path case); a case is an args tuple."""
    n = 1 << bn
    arks = arks_mont(K.MIMC_ROUNDS, dev)

    def r(*shape):
        return rand_lazy(rng, shape, dev)

    def tail_args(k, g, m):  # eq and k tables (8, G, m); an ark for the cipher gate (k = 2)
        return (r(g, m), [r(g, m) for _ in range(k)], q() if k == 2 else None)

    def fold_args(nt, g, n_):
        return ([r(g * n_) for _ in range(nt)], r(g))

    def acc_args(g, n_):
        return (r(g * n_ // 2), r(g * n_), r(g * n_), r(g))

    def eq_args(c, j, b):  # mh (C, 8, J), lo (8, J, B)
        return (r(c, j).permute(1, 0, 2).contiguous(), r(j, b))

    def round_args(g):  # Q (8, 8, G); alpha, beta, ck, q_k (8, G)
        return (r(8, g), r(g), r(g), r(g), r(g))

    def coeff_args(g, n_):  # eq, x0, x1 (8, G*n) with a random eq; ark (8, G)
        return (r(g * n_), r(g * n_), r(g * n_), r(g), g)

    def cpe_args(g, n_, skip):
        return (r(g * n_), r(g * n_), r(g * n_), r(g), g, K.CIPHER_EVALS, skip)

    def ipe_args(g, n_, skip):
        return (r(g * n_), r(g * n_), g, K.IDENTITY_EVALS, skip)

    def q():  # one scalar (8,)
        return r(1)[:, 0].contiguous()

    edges = edge_table(LAZY_EDGES, dev)
    redges = edge_table(LAZY_EDGES[::-1], dev)
    # every pair of edge values as (l, r) with each edge value as ark
    el = edge_table([x for x in LAZY_EDGES for _ in LAZY_EDGES], dev)
    er = edge_table([y for _ in LAZY_EDGES for y in LAZY_EDGES], dev)
    ark_edges = [edge_table([a], dev)[:, 0].contiguous() for a in LAZY_EDGES]
    # the Gruen round at the lazy edges: every input 2p - 1, and S = 2p - 1
    # against x0, x1 and ark cycled over the edges (G = 1 and G = 2)
    top = edge_table([2 * P - 1] * 64, dev)
    cyc = edge_table([LAZY_EDGES[i % len(LAZY_EDGES)] for i in range(128)], dev)
    gruen_edges = [(top[:, :16].contiguous(), top[:, :32].contiguous(), top[:, :32].contiguous(),
                    top[:, :1].contiguous()),
                   (top, cyc, cyc.flip(1).contiguous(), top[:, :1].contiguous()),
                   (top[:, :32].contiguous(), cyc[:, :64].contiguous(), cyc[:, 64:].contiguous(),
                    cyc[:, 3:5].contiguous())]
    # the tail rounds at the lazy edges: every input 2p - 1 (m = 64), and the
    # tables cycled over the edges with each edge as ark (m = 128; G = 4 x 2)
    def lanes(x, g):
        return x.reshape(L, g, -1).contiguous()

    tail_edges = [(lanes(top, 1), [lanes(top, 1)] * 2, top[:, 0].contiguous()),
                  (lanes(cyc, 1), [lanes(cyc.flip(1), 1), lanes(cyc, 1)], ark_edges[8]),
                  (lanes(cyc[:, :8], 4), [lanes(cyc[:, 8:16], 4)], None)]
    tail_edges += [(lanes(cyc[:, :8], 4), [lanes(cyc[:, 8:16], 4), lanes(cyc[:, 16:24], 4)], a) for a in ark_edges]
    # the direct rounds at the lazy edges: every input 2p - 1; eq = 2p - 1
    # against x0, x1 and ark cycled over the edges; eq cycled too (G = 2)
    direct_edges = [(top[:, :32].contiguous(), top[:, :32].contiguous(), top[:, :32].contiguous(),
                     top[:, :1].contiguous(), 1),
                    (top, cyc[:, :64].contiguous(), cyc[:, 64:].contiguous(), top[:, :1].contiguous(), 1),
                    (cyc[:, 64:].contiguous(), cyc[:, :64].contiguous(), cyc.flip(1)[:, :64].contiguous(),
                     cyc[:, 3:5].contiguous(), 2)]
    # the identity rounds at the same edges: eq = x = 2p - 1; eq = 2p - 1
    # against x cycled over the edges; both cycled (G = 2)
    identity_edges = [(top[:, :32].contiguous(), top[:, :32].contiguous(), 1), (top, cyc[:, :64].contiguous(), 1),
                      (cyc[:, 64:].contiguous(), cyc.flip(1)[:, :64].contiguous(), 2)]

    # small cases: G = 1, 2 and 4; both claim-trick settings (skip_t0 False
    # is the output layer's full first round)
    return [
        ("mimc_witness", [(r(2), r(2), arks), (r(1 << 16), r(1 << 16), arks)],
         lambda: (r(n), r(n), arks)),
        ("mimc_hash", [(r(1),), (r(3),), (r(9),)], lambda: (r(9),)),
        ("mimc_hash_g", [(r(9, 1),), (r(9, 2048),)], lambda: (r(9, 91 * bn),)),
        ("fold", [fold_args(1, 1, 2), fold_args(2, 4, 2), fold_args(4, 1, 8),
                  fold_args(2, 1, 1 << 16), fold_args(1, 4, 1 << 14),
                  fold_args(3, 1, 2), fold_args(3, 2, 1 << 10), fold_args(3, 4, 1 << 12)],
         lambda: fold_args(2, 1, n)),
        ("suffix_step", [(r(1), r(1)), (r(4 * 2), r(4)), (r(1 << 15), r(1)), (r(4 << 13), r(4))],
         lambda: (r(n // 4), r(1))),
        ("multi_eq", [eq_args(1, 10, 8), eq_args(3, 5, 2), eq_args(64, 91, 1 << 10),
                      eq_args(max(1, n >> 10), 1, min(n, 1 << 10))],  # one claim, as every cipher layer off Gruen
         lambda: eq_args(max(1, n >> 10), 91, min(n, 1 << 10))),
        ("mul_scalar", [(r(1), q()), (r(512), q()), (r(3000), q())],
         lambda: (r(n // 2), q())),  # the largest doubling step, 2^(bn-1) -> 2^bn
        # G = 1, 2, 4, ragged halves (1 and 64 points), the lazy edges, and
        # G = 4 x 2^(bn-2) (the grouped path's tables), where a block sums
        # more points than one flush interval of the s32 digit sums (last in
        # the list of each deferred round)
        ("gruen_acc", [acc_args(1, 2), acc_args(4, 2), acc_args(2, 128), acc_args(1, 1 << 16),
                       acc_args(4, 1 << 12)] + gruen_edges + [acc_args(GROUPS, n // GROUPS)],
         lambda: acc_args(1, n)),
        ("cipher_coeff_acc", [coeff_args(1, 2), coeff_args(2, 2), coeff_args(4, 8), coeff_args(1, 1 << 16),
                              coeff_args(2, 1 << 10), coeff_args(4, 1 << 12)] + direct_edges
         + [coeff_args(GROUPS, n // GROUPS)],
         lambda: coeff_args(1, n)),
        # the identity rounds also at 64 points (half a tile) and G = 3 x 2^16
        # (256 tiles a group, not a multiple of its blocks)
        ("identity_acc", [(r(2), r(2), 1), (r(8), r(8), 4), (r(128), r(128), 1), (r(1 << 16), r(1 << 16), 1),
                          (r(4 << 12), r(4 << 12), 4), (r(3 << 16), r(3 << 16), 3)] + identity_edges
         + [(r(n), r(n), GROUPS)],
         lambda: (r(n), r(n), 1)),
        ("cipher_partial_evals", [cpe_args(g, m, skip) for g, m in ((1, 2), (2, 8), (4, 1 << 12), (1, 1 << 16))
                                  for skip in (False, True)]
         + [e + (K.CIPHER_EVALS, skip) for e in direct_edges for skip in (False, True)]
         + [cpe_args(GROUPS, n // GROUPS, True)],
         lambda: cpe_args(1, n, True)),
        ("identity_partial_evals", [ipe_args(g, m, skip) for g, m in ((1, 2), (2, 8), (1, 128), (4, 1 << 12),
                                                                      (1, 1 << 16), (3, 1 << 16))
                                    for skip in (False, True)]
         + [e + (K.IDENTITY_EVALS, skip) for e in identity_edges for skip in (False, True)]
         + [ipe_args(GROUPS, n // GROUPS, True)],
         lambda: ipe_args(1, n, True)),
        ("gruen_round_scalar", [round_args(1), round_args(2), round_args(4), round_args(2048)],
         lambda: round_args(1)),
        ("pow7", [(r(1),), (r(3),), (r(257),), (r(100003),), (edges,), (redges,)],
         lambda: (r(n),)),
        ("cipher_layer", [(r(1), r(1), q()), (r(3), r(3), q()), (r(100003), r(100003), q())]
         + [(el, er, a) for a in ark_edges],
         lambda: (r(n), r(n), q())),
        # both gates at G = 1 and 4, the main path's 2^8 entries and a single
        # round, the largest tail (2^10, 96 KB of tables) and the lazy edges
        ("tail_rounds", [tail_args(k, g, m) for k in (2, 1) for g in (1, GROUPS) for m in (1 << 8, 2)]
         + [tail_args(2, 2, 1 << K.TAIL_MAX_BITS), tail_args(1, 1, 1 << K.TAIL_MAX_BITS)] + tail_edges,
         lambda: tail_args(2, 1, 1 << min(bn, sumcheck_prover.TAIL_BITS))),
    ]


# Extra shapes timed beside the main one (name -> label, args factory).
def extra_timings(bn: int, dev, rng):
    def r(*shape):
        return rand_lazy(rng, shape, dev)

    m = 1 << (bn - 2)  # G = 4 lanes of 2^(bn-2): the grouped path's tables
    tail = min(bn, sumcheck_prover.TAIL_BITS)
    return {
        "fold": ("nt = 3 (eq, x0, x1)", lambda: ([r(1 << bn) for _ in range(3)], r(1))),
        "cipher_partial_evals": (f"G = {GROUPS}", lambda: (r(GROUPS * m), r(GROUPS * m), r(GROUPS * m), r(GROUPS),
                                                          GROUPS, K.CIPHER_EVALS, True)),
        "identity_partial_evals": (f"G = {GROUPS}", lambda: (r(GROUPS * m), r(GROUPS * m), GROUPS,
                                                            K.IDENTITY_EVALS, True)),
        "gruen_round_scalar": (f"G = {GROUPS}", lambda: (r(8, GROUPS),) + tuple(r(GROUPS) for _ in range(4))),
        # the identity layer's tail
        "tail_rounds": ("the identity gate", lambda: (r(1, 1 << tail), [r(1, 1 << tail)], None)),
    }


def work(name: str, args) -> tuple[int, int, int]:
    """(bytes moved, 32-bit multiply results, int8 tensor-core operations)
    of one call: each input read and each output written once."""
    if name in ("identity_acc", "identity_partial_evals"):
        # the identity rounds' deferred algorithm: eq and x read once, the
        # 32 x 64 byte MACs a weight row a point, one product to Montgomery
        # form a coefficient (3 a group)
        eq, g = args[0], args[2]
        n_out = 3 if name == "identity_acc" else args[3] - bool(args[4])
        return (FE * (2 * eq.shape[-1] + n_out * g), 3 * g * MULS_PER_PRODUCT,
                2 * WEIGHT_ROWS[name] * IDENTITY_MACS * (eq.shape[-1] // 2))
    if name in WEIGHT_ROWS:
        # the deferred algorithm: 9 full and 8 unreduced products a point,
        # the 32 x 512 byte MACs of its digit contraction a weight row, one
        # product to Montgomery form a coefficient (8 or 9 a group)
        if name == "gruen_acc":
            s_, x0, _, ark = args
            points, g = s_.shape[-1], ark.shape[-1]
            nbytes, coeffs = FE * (points + 4 * points + g + 8 * g), 8
        else:
            eq, g = args[0], args[4]
            points, n_out = eq.shape[-1] // 2, 9 if name == "cipher_coeff_acc" else args[5] - bool(args[6])
            nbytes, coeffs = FE * (3 * eq.shape[-1] + g + n_out * g), 9
        return (nbytes,
                (DEFERRED_FULL * MULS_PER_PRODUCT + DEFERRED_WIDE * WIDE_RESULTS) * points
                + coeffs * g * MULS_PER_PRODUCT,
                2 * WEIGHT_ROWS[name] * DEFERRED_MACS * points)
    nbytes, products = products_work(name, args)
    return nbytes, products * MULS_PER_PRODUCT, 0


def products_work(name: str, args) -> tuple[int, int]:
    """(bytes moved, Montgomery products) of one call of a kernel that
    reduces every product."""
    if name == "mimc_witness":
        block, _, arks = args
        n, rounds = block.shape[-1], arks.shape[0]
        return FE * (2 * n + rounds + rounds * n), 4 * rounds * n
    if name in ("mimc_hash", "mimc_hash_g"):
        k = args[0].shape[1]
        g = args[0].shape[2] if args[0].dim() == 3 else 1
        return FE * (k * g + K.MIMC_ROUNDS + g), 4 * K.MIMC_ROUNDS * k * g
    if name == "fold":
        tables, rr = args
        total = sum(t.shape[-1] for t in tables)
        return FE * (total + total // 2 + rr.shape[-1]), total // 2
    if name == "suffix_step":
        t, q = args
        return FE * (3 * t.shape[-1] + q.shape[-1]), t.shape[-1]
    if name == "multi_eq":
        mh, lo = args
        c, j, b = mh.shape[0], mh.shape[2], lo.shape[2]
        return FE * (c * j + j * b + c * b), c * j * b
    if name == "mul_scalar":
        x, _ = args
        return FE * (2 * x.shape[-1] + 1), x.shape[-1]
    # cipher_evals_per_t: the cipher round at every t, cipher_pe_variant's design
    if name == "cipher_evals_per_t":
        eq, g, n_evals, skip = args[0], args[-3], args[-2], args[-1]
        n_out = n_evals - bool(skip)
        # x^7 and the eq weight at each t
        return FE * (3 * eq.shape[-1] + g + n_out * g), 5 * n_out * (eq.shape[-1] // 2)
    if name == "pow7":  # square, mul, square, mul per element
        n = args[0].shape[-1]
        return FE * 2 * n, 4 * n
    if name == "cipher_layer":
        n = args[0].shape[-1]
        return FE * (3 * n + 1), 4 * n
    if name == "tail_rounds":
        eq, xs, ark = args
        g, m, k = eq.shape[1], eq.shape[2], len(xs)
        e, s = (K.CIPHER_EVALS if ark is not None else K.IDENTITY_EVALS), m.bit_length() - 1
        per_t = 5 if ark is not None else 1  # x^7 and the eq weight, or the eq weight
        # m - 1 pairs over the rounds: the sums at E points and the folds of
        # 1 + k tables; a round's interpolation (E^2) and hash (E words x 91 x 4)
        products = g * ((m - 1) * (e * per_t + 1 + k) + s * (e * e + 4 * K.MIMC_ROUNDS * e))
        return (FE * ((1 + k) * g * m + (ark is not None) + e * e + K.MIMC_ROUNDS + s * (e + 1) * g + (1 + k) * g),
                products)
    if name == "gruen_round_scalar":
        g = args[0].shape[-1]
        # combine 16 + 9, hash 9 words x 91 rounds x 4, eq1 and ck' 2
        return FE * (12 * g + K.MIMC_ROUNDS + 11 * g), (25 + 9 * 4 * K.MIMC_ROUNDS + 2) * g
    raise KeyError(name)


def bound(name: str, args) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes' time and the operations' time, each kind of operation at
    its own rate."""
    nbytes, results, int8_ops = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (results / INT_MULS_PER_S + int8_ops / Pr.INT8_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


CHAIN_KERNELS = ("mimc_hash", "gruen_round_scalar")
SBOX_DEPTH = 3  # dependent products an S-box of the hash chain (csrc/mimc.cuh)


# reduced products a point of the design before the deferred one, at the
# main path's shapes (cipher_partial_evals: t = 1..8, 5 a t; the identity
# rounds: 4 for the coefficients, 1 a t at t = 1, 2)
OLD_PRODUCTS = {"gruen_acc": 25, "cipher_coeff_acc": 33, "cipher_partial_evals": 40, "identity_acc": 4,
                "identity_partial_evals": 2}


def log_deferred(name: str, bn: int, flush_case) -> None:
    """The bound of the design before the deferred one, and how many points
    a block of the flush-interval case sums."""
    old_ms = OLD_PRODUCTS[name] * (1 << (bn - 1)) * MULS_PER_PRODUCT / INT_MULS_PER_S * 1e3
    if name == "gruen_acc":
        g = flush_case[3].shape[-1]
        half = flush_case[0].shape[-1] // g
    else:
        g = flush_case[2 if name.startswith("identity") else 4]
        half = flush_case[0].shape[-1] // g // 2
    if name.startswith("identity"):
        tile, flush, bpg = K.IDENTITY_TILE, K.IDENTITY_FLUSH_POINTS, K._identity_blocks(half, g, flush_case[0].device)
    else:
        tile, flush, bpg = K.DEFERRED_TILE, K.DEFERRED_FLUSH_POINTS, K._deferred_blocks(half, g, flush_case[0].device)
    tiles = -(-half // tile)
    log(f"# kernel {name}: bound of the {OLD_PRODUCTS[name]}-product design at the main shapes {old_ms:.6f} ms "
        f"(operations); G={g} x 2^{half.bit_length() - 1} points case: a block sums up to "
        f"{-(-tiles // bpg) * tile} points (s32 digit sums flushed every {flush})")


def log_chain(name: str, ms: float, dev, rng) -> None:
    """ns a product of the hash chain: for mimc_hash the slope between
    K = 1 and K = 9 words (91 S-boxes a word), for the round stage its time
    over its 9 x 91 S-boxes; each as ns an S-box, a dependent product (an
    S-box is SBOX_DEPTH deep) and a product (4 an S-box)."""
    sboxes = 9 * K.MIMC_ROUNDS
    if name == "mimc_hash":
        ms1 = time_kernel(K.mimc_hash, (rand_lazy(rng, (1,), dev),))
        ms = time_kernel(K.mimc_hash, (rand_lazy(rng, (9,), dev),))
        per_sbox, how = (ms - ms1) * 1e6 / (8 * K.MIMC_ROUNDS), f"slope K = 1 -> 9 ({ms1:.4f} -> {ms:.4f} ms)"
    else:
        per_sbox, how = ms * 1e6 / sboxes, f"{ms:.4f} ms over {sboxes} S-boxes"
    log(f"# chain {name}: {per_sbox:.1f} ns an S-box, {per_sbox / SBOX_DEPTH:.1f} ns a dependent product, "
        f"{per_sbox / 4:.1f} ns a product ({how})")


def log_tail_floor(ms: float, args, dev, rng, label: str = "") -> None:
    """The tail rounds against their chain floor: log2(m) dependent hashes
    of E words each (mimc_hash at E words, timed here)."""
    eq, _, ark = args
    s, e = eq.shape[-1].bit_length() - 1, (K.CIPHER_EVALS if ark is not None else K.IDENTITY_EVALS)
    hash_ms = time_kernel(K.mimc_hash, (rand_lazy(rng, (e,), dev),))
    log(f"# chain floor tail_rounds{label}: {s} x mimc_hash at {e} words ({hash_ms:.4f} ms) = {s * hash_ms:.4f} ms; "
        f"the kernel {ms:.4f} ms is {ms / (s * hash_ms):.3f}x it")


def phase_kernels(bn: int, dev) -> dict:
    rng = np.random.default_rng(2024)
    results = {}
    extras = extra_timings(bn, dev, rng)
    for name, small, main in kernel_cases(bn, dev, rng):
        kern, plain = getattr(K, name), K.PLAIN[name]
        err = 0
        for args in small:
            got, want = kern(*args), plain(*args)
            sync()
            e = max_abs_err(got, want)
            if e:
                raise AssertionError(f"{name}: kernel != plain (max limb diff {e})")
            err = max(err, e)
        args = main()
        ms = time_kernel(kern, args)
        got = kern(*args)
        want, plain_ms = time_once(plain, args)
        err = max(err, max_abs_err(got, want))
        if err:
            raise AssertionError(f"{name}: kernel != plain at the main shapes (max limb diff {err})")
        bound_ms, bound_by = bound(name, args)
        if name == "tail_rounds":
            log_tail_floor(ms, args, dev, rng)
        del got, want, args
        torch.cuda.empty_cache()
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
        log(f"# kernel {name}: bit-equal to plain; {ms:.4f} ms kernel vs {plain_ms:.2f} ms plain, "
            f"bound {bound_ms:.6f} ms ({bound_by}) at the bn={bn} main-path shapes")
        if name in WEIGHT_ROWS:
            log_deferred(name, bn, small[-1])
        if name in CHAIN_KERNELS:
            log_chain(name, ms, dev, rng)
        if name in extras:
            label, make = extras[name]
            args = make()
            x_ms = time_kernel(kern, args)
            got = kern(*args)
            want, x_plain_ms = time_once(plain, args)
            if max_abs_err(got, want):
                raise AssertionError(f"{name}: kernel != plain at {label}")
            x_bound, x_by = bound(name, args)
            log(f"# kernel {name} at {label}: bit-equal to plain; {x_ms:.4f} ms kernel vs "
                f"{x_plain_ms:.2f} ms plain, bound {x_bound:.6f} ms ({x_by})")
            if name == "tail_rounds":
                log_tail_floor(x_ms, args, dev, rng, f" at {label}")
    return results


# ---------------------------------------------------------------------------
# Phase 3: golden transcripts
# ---------------------------------------------------------------------------


def phase_golden(dev) -> None:
    if mimc_hash([12]) != MIMC_KAT:
        raise AssertionError("host MimcHash([12]) known answer")
    if fr.to_int(mimc_hash_device(fr.encode_mont_ints([12], dev))) != MIMC_KAT:
        raise AssertionError("device MimcHash([12]) known answer")
    golden = json.loads((ROOT / "tests" / "golden" / "transcripts.json").read_text())

    def strs(x):
        return [strs(v) for v in x] if isinstance(x, list) else str(x)

    for tail_bits in (8, 1):
        for bn in (1, 2, 3):
            xs, claims, qps, gate = testing.initialize_cipher_gate_instance(bn, dev)
            scp = sumcheck_prover.prove(xs, testing.to_device_qprimes(qps, dev),
                                        testing.to_device_claims(claims, dev), gate, tail_bits)
            want = golden["sumcheck"][f"cipher_bn{bn}"]
            if (strs(rows_to_ints(scp.coeffs)) != want["coeffs"]
                    or strs(rows_to_ints(scp.challenges)) != want["challenges"]
                    or strs(rows_to_ints(scp.final_claims)) != want["final_claims"]):
                raise AssertionError(f"golden cipher_bn{bn} (tail_bits={tail_bits})")
        xs, claims, qps, gate = testing.initialize_multi_instance(3, 10, dev)
        scp = sumcheck_prover.prove(xs, testing.to_device_qprimes(qps, dev),
                                    testing.to_device_claims(claims, dev), gate, tail_bits)
        want = golden["sumcheck"]["multi_bn3_j10"]
        if (strs(rows_to_ints(scp.coeffs)) != want["coeffs"]
                or strs(rows_to_ints(scp.final_claims)) != want["final_claims"]):
            raise AssertionError(f"golden multi_bn3_j10 (tail_bits={tail_bits})")
        want = golden["gkr_mimc"]
        bn = want["bn"]
        block = fr.encode_mont_ints(random_fr_array(1 << bn), dev)
        c = mimc_circuit()
        a = assign_fused(block, block.clone())
        qprime = ints_to_rows(random_fr_array(bn), dev)
        proof = gkr_prover.prove(c, a, qprime, tail_bits)
        if strs(fr.to_ints(a[93])) != want["outputs"] or strs(proof_to_vec(c, proof)) != want["proof_vec"]:
            raise AssertionError(f"golden gkr_mimc bn={bn} (tail_bits={tail_bits})")
        gkr_verifier.verify(c, proof, [block, block], a[93], qprime)
        log(f"# golden: cipher_bn1..3, multi_bn3_j10, gkr_mimc bn={bn} reproduced (tail_bits={tail_bits})")


# ---------------------------------------------------------------------------
# Phases 4, 5 and 6: GKR walks
# ---------------------------------------------------------------------------


def walk_inputs(bn: int, dev):
    """The main path's inputs on the card: block = state = the generator's
    stream at 0, qprime = random_fr_array(bn)."""
    block = fr.to_mont(random_fr_device(1 << bn, 0, dev))
    return block, block.clone(), ints_to_rows(random_fr_array(bn), dev)


def walk(bn: int, dev):
    """Inputs on the card -> witness -> proof; returns timings and artifacts."""
    c = mimc_circuit()
    sync()
    t0 = time.perf_counter()
    block, state, qprime = walk_inputs(bn, dev)
    sync()
    t1 = time.perf_counter()
    a = assign_fused(block, state)
    sync()
    t2 = time.perf_counter()
    proof = gkr_prover.prove(c, a, qprime)
    sync()
    t3 = time.perf_counter()
    times = {"inputs_s": t1 - t0, "witness_s": t2 - t1, "prove_s": t3 - t2}
    return c, block, state, qprime, a, proof, times


def phase_cross_check(bn: int, dev) -> None:
    c, *_, proof, t_k = walk(bn, dev)
    vec_kernel = proof_to_vec(c, proof)
    del proof
    with plain_twins():
        c, *_, proof, t_p = walk(bn, dev)
    vec_plain = proof_to_vec(c, proof)
    if vec_kernel != vec_plain:
        raise AssertionError(f"bn={bn}: kernel and plain walks differ")
    log(f"# cross-check bn={bn}: kernel and plain walks give identical proof vectors "
        f"({len(vec_kernel)} elements); prove {t_k['prove_s']:.2f} s kernels vs "
        f"{t_p['prove_s']:.2f} s plain")


def grouped_walk(bn: int, g: int, dev, tail_bits: int = sumcheck_prover.TAIL_BITS):
    """G instances: inputs on the card -> witness -> one grouped proof."""
    c = mimc_circuit()
    sync()
    t0 = time.perf_counter()
    block, state, qprime = grouped_inputs(bn, g, dev)
    sync()
    t1 = time.perf_counter()
    a = assign_fused(block, state)
    sync()
    t2 = time.perf_counter()
    proof = gkr_prover.prove(c, a, qprime, tail_bits)
    sync()
    t3 = time.perf_counter()
    times = {"inputs_s": t1 - t0, "witness_s": t2 - t1, "prove_s": t3 - t2}
    return c, block, state, qprime, a, proof, times


def phase_grouped_cross_check(bn: int, g: int, dev, tail_bits: int = 2) -> None:
    """Kernel and plain grouped walks, and each lane's single walk. Small
    tail_bits put nearly every round on the head-round kernels (fused
    head rounds at G lanes); the transcript does not depend on the
    split."""
    c, block, state, qprime, _, proof, t_k = grouped_walk(bn, g, dev, tail_bits)
    vecs = [proof_to_vec(c, gkr_verifier.slice_group(proof, i)) for i in range(g)]
    del proof
    with plain_twins():
        *_, proof, t_p = grouped_walk(bn, g, dev, tail_bits)
    if [proof_to_vec(c, gkr_verifier.slice_group(proof, i)) for i in range(g)] != vecs:
        raise AssertionError(f"G={g} x bn={bn}: kernel and plain grouped walks differ")
    del proof
    for i in range(g):
        a = assign_fused(block[:, i].contiguous(), state[:, i].contiguous())
        single = gkr_prover.prove(c, a, qprime[:, i].contiguous(), tail_bits)
        if proof_to_vec(c, single) != vecs[i]:
            raise AssertionError(f"G={g} x bn={bn}: lane {i} differs from its single-instance walk")
    if len(set(map(tuple, vecs))) != g:
        raise AssertionError(f"G={g} x bn={bn}: lanes with equal proofs (inputs not per lane)")
    log(f"# grouped cross-check G={g} x bn={bn}, tail_bits={tail_bits}: kernel and plain grouped walks "
        f"identical, each lane equal to its single-instance walk; prove {t_k['prove_s']:.2f} s kernels vs "
        f"{t_p['prove_s']:.2f} s plain")


ROUND_PATHS = ("coeff", "evals")
# kernels each path must launch (beside the hash and the fold)
PATH_KERNELS = {  # tail_rounds: every layer's tail rounds
    "gruen": ["mimc_witness", "mimc_hash", "mimc_hash_g", "fold", "suffix_step", "multi_eq", "gruen_acc",
              "identity_acc", "gruen_round_scalar", "tail_rounds"],
    "coeff": ["mimc_hash", "mimc_hash_g", "fold", "multi_eq", "cipher_coeff_acc", "identity_acc", "tail_rounds"],
    "evals": ["mimc_hash", "mimc_hash_g", "fold", "multi_eq", "cipher_partial_evals", "identity_partial_evals",
              "tail_rounds"],
}


def require_launched(launches: dict, names, what: str) -> None:
    missing = [name for name in names if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")


def phase_round_paths_small(bn: int, gbn: int, g: int, dev, tail_bits: int = 2) -> dict:
    """The "coeff" and "evals" round paths against the default "gruen" path
    on the same inputs: a single walk at bn (12: its single-claim eq tables
    take the doubling build through mul_scalar) and G lanes at gbn, each
    lane against the default single walk of its inputs. Small tail_bits
    put most rounds on the kernels. Returns the launch counts of each
    path's single walk (with its verification) and, under "<path> G",
    of each path's grouped prove."""
    c = mimc_circuit()
    block, state, qprime = walk_inputs(bn, dev)
    a = assign_fused(block, state)
    want = proof_to_vec(c, gkr_prover.prove(c, a, qprime, tail_bits))
    launches = {}
    for rounds in ROUND_PATHS:
        K.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        proof = gkr_prover.prove(c, a, qprime, tail_bits, rounds=rounds)
        sync()
        prove_s = time.perf_counter() - t0
        gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
        launches[rounds] = dict(K.LAUNCHES)
        require_launched(launches[rounds], PATH_KERNELS[rounds] + ["mul_scalar"], f"the {rounds} walk at bn={bn}")
        if proof_to_vec(c, proof) != want:
            raise AssertionError(f"bn={bn}: the {rounds} walk differs from the gruen walk")
        log(f"# round path {rounds} bn={bn}, tail_bits={tail_bits}: proof vector equal to the gruen walk's, "
            f"verified; prove {prove_s:.2f} s; launches {json.dumps({k: v for k, v in launches[rounds].items() if v})}")
    del a, proof

    block, state, qprime = grouped_inputs(gbn, g, dev)
    a = assign_fused(block, state)
    singles = [proof_to_vec(c, gkr_prover.prove(c, [t[:, i].contiguous() for t in a], qprime[:, i].contiguous(),
                                                 tail_bits)) for i in range(g)]
    for rounds in ROUND_PATHS:
        K.reset_launch_counts()
        proof = gkr_prover.prove(c, a, qprime, tail_bits, rounds=rounds)
        launches[f"{rounds} G"] = dict(K.LAUNCHES)
        if [proof_to_vec(c, gkr_verifier.slice_group(proof, i)) for i in range(g)] != singles:
            raise AssertionError(f"G={g} x bn={gbn}: a lane of the {rounds} walk differs from its single gruen walk")
        gkr_verifier.verify_grouped(c, proof, [block, state], a[93], qprime)
    log(f"# round paths G={g} x bn={gbn}, tail_bits={tail_bits}: every lane of the coeff and evals walks equals "
        f"the gruen single walk of its inputs; verified; launches of the grouped evals prove "
        f"{json.dumps({k: v for k, v in launches['evals G'].items() if v})}")
    return launches


def check_outputs(out: torch.Tensor, block_off: int, state_off: int, n: int, what: str) -> None:
    """A few instances of an (8, n) output table against the host MiMC
    permutation of the generator's block and state streams."""
    idx = [0, 1, n // 3, n - 1]
    got = fr.to_ints(out[:, idx].contiguous())

    def stream(i):
        return fr.limb_values(random_fr_device(1, i, "cpu"))[0]

    want = [mimc_keyed_permutation(stream(state_off + i), stream(block_off + i)) for i in idx]
    if got != want:
        raise AssertionError(f"{what}: output table disagrees with the host MiMC permutation")


def tamper_probe(c, proof, block, state, a, qprime, what: str) -> None:
    """One flipped coefficient bit must be rejected."""
    good = proof.sumcheck_proofs[50].coeffs
    bad = good.clone()
    bad[0, 0, 0] ^= 1
    proof.sumcheck_proofs[50].coeffs = bad
    try:
        gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
    except gkr_verifier.GKRError as e:
        log(f"# {what} tamper probe rejected: {e}")
    else:
        raise AssertionError(f"{what}: a tampered proof was accepted")
    finally:
        proof.sumcheck_proofs[50].coeffs = good


def expected_launches(bn: int, rounds: str) -> dict:
    """Launches of a single walk and its verification, from the round
    schedule: 91 cipher layers and the 91-claim identity layer, each with
    max(0, bn - TAIL_BITS) head rounds, then its min(bn, TAIL_BITS) tail
    rounds in one tail_rounds launch (gate, hashes and folds inside it);
    the verifier folds the output and the two input tables once per
    variable; only the witness would evaluate a gate through
    cipher_layer, and the MiMC witness is mimc_witness."""
    head = max(0, bn - sumcheck_prover.TAIL_BITS)
    tails = 92 if bn > 0 else 0
    if rounds == "gruen":
        return {"gruen_round_scalar": 91 * head, "mimc_hash": head + 1, "tail_rounds": tails, "cipher_layer": 0}
    cipher = "cipher_coeff_acc" if rounds == "coeff" else "cipher_partial_evals"
    ident = "identity_acc" if rounds == "coeff" else "identity_partial_evals"
    big = bn >= sumcheck_prover.MULTI_EQ_MIN_BITS  # single-claim eq tables by the contraction
    return {cipher: 91 * head, ident: head, "fold": 92 * head + 3 * bn, "multi_eq": 92 if big else 1,
            # the combined claim of the evals path hashes the 91 claims again
            "mimc_hash": 92 * head + 1 + (rounds == "evals"),
            "mul_scalar": 0 if big else 91 * max(0, bn - 9), "suffix_step": 0, "gruen_acc": 0,
            "gruen_round_scalar": 0, "tail_rounds": tails, "cipher_layer": 0}


def report_launches(launches: dict, expected: dict, what: str) -> None:
    same = all(launches.get(k, 0) == v for k, v in expected.items())
    log(f"# launches on {what}: {json.dumps(launches)}")
    log(f"# expected from the round schedule: {json.dumps(expected)}; {'as expected' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError(f"launches on {what} differ from the round schedule")


def phase_main(bn: int, dev, card: str) -> dict:
    """Returns the walk's inputs, witness, times, proof vector and launch
    counts for phase 7."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    c, block, state, qprime, a, proof, times = walk(bn, dev)
    t0 = time.perf_counter()
    gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
    sync()
    times["verify_s"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require_launched(launches, PATH_KERNELS["gruen"], "the main path")
    check_outputs(a[93], 0, 0, 1 << bn, "main path")  # block = state = the stream at 0
    tamper_probe(c, proof, block, state, a, qprime, "main path")

    n = 1 << bn
    hps = n / (times["witness_s"] + times["prove_s"])
    log(f"# main path bn={bn} on {card}: inputs {times['inputs_s']:.3f} s, witness "
        f"{times['witness_s']:.3f} s, prove {times['prove_s']:.3f} s, verify {times['verify_s']:.3f} s, "
        f"{hps:,.0f} hashes proven/s (witness + prove), peak memory {peak_gb:.2f} GB")
    report_launches(launches, expected_launches(bn, "gruen"), "the main path")
    main = {"c": c, "block": block, "state": state, "qprime": qprime, "a": a, "times": times,
            "vec": proof_to_vec(c, proof), "launches": launches, "peak_gb": peak_gb}
    del proof
    return main


def phase_round_paths_main(bn: int, main: dict, dev, card: str) -> dict:
    """Phase 7: phase 5's inputs and witness proven again on the "coeff"
    and "evals" round paths; each proof verifies, rejects the tamper probe
    and has phase 5's proof vector. Returns each path's launch counts."""
    c, block, state, qprime, a = (main[k] for k in ("c", "block", "state", "qprime", "a"))
    n = 1 << bn
    launches = {}
    for rounds in ROUND_PATHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        proof = gkr_prover.prove(c, a, qprime, rounds=rounds)
        sync()
        prove_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
        sync()
        verify_s = time.perf_counter() - t0
        launches[rounds] = dict(K.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        require_launched(launches[rounds], PATH_KERNELS[rounds], f"the {rounds} path")
        if proof_to_vec(c, proof) != main["vec"]:
            raise AssertionError(f"bn={bn}: the {rounds} proof vector differs from the main path's")
        tamper_probe(c, proof, block, state, a, qprime, f"{rounds} path")
        del proof
        hps = n / (main["times"]["witness_s"] + prove_s)
        log(f"# round path {rounds} bn={bn} on {card}: proof vector equal to the main path's; prove {prove_s:.3f} s, "
            f"verify {verify_s:.3f} s, {hps:,.0f} hashes proven/s (main path's witness + this prove), "
            f"peak memory {peak_gb:.2f} GB")
        report_launches(launches[rounds], expected_launches(bn, rounds), f"the {rounds} path")
    return launches


def phase_grouped(bn: int, g: int, dev, card: str) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    c, block, state, qprime, a, proof, times = grouped_walk(bn, g, dev)
    t0 = time.perf_counter()
    gkr_verifier.verify_grouped(c, proof, [block, state], a[93], qprime)
    sync()
    times["verify_s"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require_launched(launches, PATH_KERNELS["gruen"], "the grouped path")
    n = 1 << bn
    for i in range(g):
        check_outputs(a[93][:, i], i * n, (g + i) * n, n, f"grouped lane {i}")
    # tamper probe in lane 2: rejected, and the error names the group
    lane = min(2, g - 1)
    good = proof.sumcheck_proofs[50].coeffs
    bad = good.clone()
    bad[0, 0, lane, 0] ^= 1
    proof.sumcheck_proofs[50].coeffs = bad
    try:
        gkr_verifier.verify_grouped(c, proof, [block, state], a[93], qprime)
    except gkr_verifier.GKRError as e:
        if f"group {lane}" not in str(e):
            raise AssertionError(f"tamper in lane {lane} rejected without naming it: {e}") from e
        log(f"# grouped tamper probe rejected: {e}")
    else:
        raise AssertionError("a tampered grouped proof was accepted")
    proof.sumcheck_proofs[50].coeffs = good

    hps = g * n / (times["witness_s"] + times["prove_s"])
    log(f"# grouped path G={g} x bn={bn} on {card}: inputs {times['inputs_s']:.3f} s, witness "
        f"{times['witness_s']:.3f} s, prove {times['prove_s']:.3f} s, verify {times['verify_s']:.3f} s, "
        f"{hps:,.0f} hashes proven/s (witness + prove), peak memory {peak_gb:.2f} GB")
    log(f"# launches on the grouped path: {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: the GMiMC and Poseidon circuits and hashers
# ---------------------------------------------------------------------------

POSEIDON_T2 = (2, 8, 82)  # t, RF, RP: the production configuration
POSEIDON_SMALL = (2, 2, 3)
HASHERS = [gmimc_hash.GMIMC_T2, gmimc_hash.GMIMC_T4, gmimc_hash.GMIMC_T8,
           poseidon_hash.POSEIDON_T2, poseidon_hash.POSEIDON_T4, poseidon_hash.POSEIDON_T8]


def stream_value(i: int) -> int:
    """Element i of the deterministic generator's stream, on the host."""
    return fr.limb_values(random_fr_device(1, i, "cpu"))[0]


def sampled(n: int, count: int = 256) -> list:
    return sorted(set(range(0, n, max(1, n // count))) | {n - 1})


def circuit_setup(kind: str, bn: int, dev):
    """(circuit, inputs, qprime, output oracle of instance i) of GMiMC T2
    ("gmimc"), Poseidon T2 ("poseidon") or Poseidon (2, 2, 3) ("poseidon
    small") at 2^bn instances: block word k is the generator's stream at
    offset k * 2^bn, state word k at (t + k) * 2^bn (as walk_inputs, one
    offset per word); qprime is random_fr_array(bn)."""
    n = 1 << bn
    t = 2
    words = [fr.to_mont(random_fr_device(n, k * n, dev)) for k in range(2 * t)]

    def host_words(i):
        w = [stream_value(k * n + i) for k in range(2 * t)]
        return w[:t], w[t:]

    if kind == "gmimc":
        c = gmimc.gmimc_circuit(t)
        inputs = gmimc.gmimc_inputs(words[:t], words[t + gmimc.initial_word(t)])

        def oracle(i):
            block, state = host_words(i)
            return gmimc.permutation_word_scalar(t, state, block)
    else:
        _, rf, rp = POSEIDON_T2 if kind == "poseidon" else POSEIDON_SMALL
        c = poseidon.poseidon_circuit(t, rf, rp)
        inputs = poseidon.poseidon_inputs(words[:t], words[t:])

        def oracle(i):
            block, state = host_words(i)
            return poseidon.permutation_word_scalar(t, rf, rp, state, block)
    return c, inputs, ints_to_rows(random_fr_array(bn), dev), oracle


def n_cipher(c) -> int:
    return sum(type(layer.gate).__name__ == "CipherGate" for layer in c)


def n_tail(c) -> int:
    """Layers whose sumcheck ends in one tail_rounds launch: a cipher gate
    over two tables or an identity gate over one."""
    return sum((type(layer.gate).__name__, len(layer.in_)) in (("CipherGate", 2), ("IdentityGate", 1))
               for layer in c)


@contextmanager
def layer_timer(times: dict):
    """Seconds of every layer's sumcheck in a GKR walk, by (gate, claims),
    with a synchronise before and after each layer."""
    inner = sumcheck_prover.prove

    def timed(xs, qprimes, claims, gate, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = inner(xs, qprimes, claims, gate, *args, **kwargs)
        sync()
        times.setdefault((gate.name, qprimes.shape[0]), []).append(time.perf_counter() - t0)
        return out

    sumcheck_prover.prove = timed
    try:
        yield
    finally:
        sumcheck_prover.prove = inner


def circuit_walk(kind: str, bn: int, dev, card: str) -> dict:
    """One circuit at 2^bn instances on the default path: generic witness,
    proof (each layer timed), verification, tamper probe, and the output
    table against the host permutation at 257 sampled instances."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = 1 << bn
    c, inputs, qprime, oracle = circuit_setup(kind, bn, dev)
    sync()
    t0 = time.perf_counter()
    a = assign(c, inputs)
    sync()
    t1 = time.perf_counter()
    layer_s: dict = {}
    with layer_timer(layer_s):
        proof = gkr_prover.prove(c, a, qprime)
    t2 = time.perf_counter()
    gkr_verifier.verify(c, proof, inputs, a[-1], qprime)
    sync()
    t3 = time.perf_counter()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    idx = sampled(n)
    if fr.to_ints(a[-1][:, idx].contiguous()) != [oracle(i) for i in idx]:
        raise AssertionError(f"{kind} bn={bn}: output table disagrees with the host permutation")
    layer = len(c) // 2
    good = proof.sumcheck_proofs[layer].coeffs
    bad = good.clone()
    bad[0, 0, 0] ^= 1
    proof.sumcheck_proofs[layer].coeffs = bad
    try:
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)
    except gkr_verifier.GKRError as e:
        log(f"# {kind} bn={bn} tamper probe rejected: {e}")
    else:
        raise AssertionError(f"{kind} bn={bn}: a tampered proof was accepted")
    kinds: dict = {}
    for (gate, j), ts in sorted(layer_s.items()):
        k = kinds.setdefault(gate, {"layers": 0, "s": 0.0})
        k["layers"] += len(ts)
        k["s"] += sum(ts)
        log(f"#   {kind} layers {gate} with {j} claim(s): {len(ts)} layers, {sum(ts):.3f} s, "
            f"{1e3 * sum(ts) / len(ts):.1f} ms a layer")
    out = {"bn": bn, "layers": len(c), "assign_s": t1 - t0, "prove_s": t2 - t1, "verify_s": t3 - t2,
           "hashes_per_s": n / (t2 - t0), "peak_gb": peak_gb,
           "ms_per_layer": {g: 1e3 * k["s"] / k["layers"] for g, k in kinds.items()}}
    log(f"# {kind} bn={bn} ({len(c)} layers) on {card}: assign {out['assign_s']:.3f} s, prove "
        f"{out['prove_s']:.3f} s (each layer synchronised), verify {out['verify_s']:.3f} s, "
        f"{out['hashes_per_s']:,.0f} verified hashes proven/s (assign + prove), peak memory {peak_gb:.2f} GB; "
        f"output equal to the host permutation at {len(idx)} instances; ms a layer "
        f"{json.dumps({g: round(v, 1) for g, v in out['ms_per_layer'].items()})}")
    return out


def circuits_cross_check(bn: int, dev, tail_bits: int = 2) -> dict:
    """GMiMC T2 and Poseidon (2, 2, 3) at bn through the kernels and again
    through the plain twins: equal witnesses and proof vectors; then GMiMC's
    full-state prover. Returns the cipher_layer (one a cipher layer of a
    witness) and tail_rounds (one a cipher or identity layer of a proof)
    launches these runs make."""
    launches = {"cipher_layer": 0, "tail_rounds": 0}
    for kind in ("gmimc", "poseidon small"):
        c, inputs, qprime, _ = circuit_setup(kind, bn, dev)
        a = assign(c, inputs)
        proof = gkr_prover.prove(c, a, qprime, tail_bits)
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)
        vec = proof_to_vec(c, proof)
        with plain_twins():
            a_plain = assign(c, inputs)
            vec_plain = proof_to_vec(c, gkr_prover.prove(c, a_plain, qprime, tail_bits))
        if not all(torch.equal(x, y) for x, y in zip(a, a_plain)) or vec != vec_plain:
            raise AssertionError(f"{kind} bn={bn}: kernel and plain walks differ")
        launches["cipher_layer"] += n_cipher(c)
        launches["tail_rounds"] += n_tail(c)
        log(f"# {kind} bn={bn}, tail_bits={tail_bits}: kernel and plain witnesses and proof vectors identical "
            f"({len(vec)} elements), verified")
    t, n = 2, 1 << bn
    blocks = [fr.to_mont(random_fr_device(n, k * n, dev)) for k in range(t)]
    states = [fr.to_mont(random_fr_device(n, (t + k) * n, dev)) for k in range(t)]
    qprime = ints_to_rows(random_fr_array(bn), dev)
    results = gmimc.prove_full_state(t, blocks, states, qprime)
    gmimc.verify_full_state(t, blocks, states, qprime, results)
    idx = sampled(n, 32)
    for w, (c, a, _) in enumerate(results):
        launches["cipher_layer"] += n_cipher(c)
        launches["tail_rounds"] += n_tail(c)
        want = [gmimc.permutation_word_scalar(t, [stream_value((t + k) * n + i) for k in range(t)],
                                              [stream_value(k * n + i) for k in range(t)], w) for i in idx]
        if fr.to_ints(a[-1][:, idx].contiguous()) != want:
            raise AssertionError(f"gmimc full state bn={bn}: word {w} disagrees with the host permutation")
    log(f"# gmimc full state t={t} bn={bn}: {t} words proven and verified, outputs equal to the host permutation")
    return launches


def hashers_check(dev, m: int = 1 << 16) -> int:
    """The six device hashers over m messages of t + 3 words (two blocks)
    against the host hash at sampled messages. Returns the expected pow7
    launches (one a round of each block)."""
    launches = 0
    for h in HASHERS:
        k = h.t + 3
        msgs = fr.to_mont(random_fr_device(k * m, 0, dev)).reshape(L, k, m)
        out, ms = time_once(h.hash_batch, (msgs,))
        idx = sampled(m, 32)
        want = [h.hash([stream_value(w * m + i) for w in range(k)]) for i in idx]
        if fr.to_ints(out[:, idx].contiguous()) != want:
            raise AssertionError(f"{type(h).__name__} t={h.t}: device hash_batch disagrees with the host hash")
        rounds = h.n_rounds if hasattr(h, "n_rounds") else 2 * h.n_rounds_f + h.n_rounds_p
        launches += rounds * -(-k // h.t)
        log(f"# {type(h).__name__} t={h.t}: hash_batch of {m} messages of {k} words in {ms:.2f} ms, "
            f"equal to the host hash at {len(idx)} messages")
    return launches


def phase_circuits(bn: int, pbn: int, dev, card: str) -> dict:
    """Phase 8. Returns the walks' summaries and the launch counts of the
    whole phase (counts set to 0 just before it)."""
    K.reset_launch_counts()
    walks = {"gmimc": circuit_walk("gmimc", bn, dev, card)}
    walks["poseidon"] = circuit_walk("poseidon", pbn, dev, card)
    walked = (gmimc.gmimc_circuit(2), poseidon.poseidon_circuit(*POSEIDON_T2))
    torch.cuda.empty_cache()
    expected = circuits_cross_check(min(10, bn), dev)
    expected["cipher_layer"] += sum(map(n_cipher, walked))
    expected["tail_rounds"] += sum(map(n_tail, walked))
    expected["pow7"] = hashers_check(dev)
    launches = dict(K.LAUNCHES)
    require_launched(launches, ["cipher_layer", "pow7", "gruen_acc", "gruen_round_scalar", "suffix_step",
                                "cipher_coeff_acc", "identity_acc", "multi_eq", "fold", "mimc_hash", "mimc_hash_g",
                                "tail_rounds"], "phase 8")
    same = all(launches[k] == v for k, v in expected.items())
    log(f"# launches in phase 8: {json.dumps(launches)}")
    log(f"# expected: {json.dumps(expected)}; {'as expected' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("launches in phase 8 differ from the expected counts")
    return {"walks": walks, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 9: the probes
# ---------------------------------------------------------------------------


def probe_bound(name: str, args) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") of a probe
    call: its 32-bit results at the data-sheet rate of their kind (int8
    tensor-core operations for imma_dot), or its bytes."""
    if name == "op_chain":
        x, _, body, reps = args[:4]
        results, rate = Pr.OP_BODIES[body]
        nbytes, t_ops = 3 * x.numel() * 4, reps * x.numel() * results / rate
    elif name == "imma_dot":
        m, x, reps = args[:3]
        n = x.shape[1]
        nbytes, t_ops = m.numel() + x.numel() + 4 * 64 * n, 2 * reps * 64 * 32 * n / Pr.INT8_OPS_PER_S
    elif name == "field_check":  # mul, four products of x^7, a square
        n = args[0].shape[1]
        nbytes, t_ops = 5 * FE * n, (5 * MULS_PER_PRODUCT + Pr.CHAIN_VARIANTS["square"]) * n / INT_MULS_PER_S
    elif name == "mul_chain":
        a, _, variant, chain = args[:4]
        n = a.shape[1]
        nbytes, t_ops = 3 * FE * n, Pr.CHAIN_VARIANTS[variant] * chain * n / INT_MULS_PER_S
    elif name == "sbox_chain":
        x, _, rounds = (args + (Pr.SBOX_ROUNDS,))[:3]
        n = x.shape[1]
        nbytes, t_ops = 2 * FE * n, 4 * rounds * MULS_PER_PRODUCT * n / INT_MULS_PER_S
    elif name == "cipher_pe_variant":  # the per-t design: 5 reduced products a t
        eq, x0, x1, ark = args[:4]
        nbytes, products = products_work("cipher_evals_per_t", (eq, x0, x1, ark, 1, K.CIPHER_EVALS, False))
        t_ops = products * MULS_PER_PRODUCT / INT_MULS_PER_S
    else:
        raise KeyError(name)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


PARENT_IMMA_MS = 0.4461  # the first port's mma.sync imma_dot at the timed shape (PERF.md's kernel table)
PARENT_SBOX_NS = {"col": 2405, "row": 2407}  # the first port's CIOS chains, ns an S-box (PERF.md's kernel table)


def log_redesigned_probes(runs: dict, rows: dict) -> None:
    """The two redesigned probes beside their yardsticks: imma_dot (wgmma)
    against its bound, the first port's mma.sync time and torch._int_mm at
    equal work; each sbox_chain layout's dependent product beside the
    first port's chain and the transcript hash chain's (csrc/mimc.cuh)."""
    mo, row = runs["micro_ops"], rows["imma_dot"]
    ms, (m, x, reps, _) = mo["imma_dot"]
    eq_ms, (a, b) = mo["int_mm_equal"]
    macs, eq_macs = reps * 64 * 32 * x.shape[1], a.shape[0] * a.shape[1] * b.shape[1]
    log(f"# redesigned imma_dot (wgmma m64n256k32): {ms:.4f} ms, {macs / ms / 1e9:.1f} T MAC/s, "
        f"{row['bound_ms'] / ms:.1%} of its bound {row['bound_ms']:.4f} ms; parent (mma.sync) {PARENT_IMMA_MS} ms "
        f"(PERF.md); torch._int_mm at equal work {eq_ms:.4f} ms, {eq_macs / eq_ms / 1e9:.1f} T MAC/s: the kernel at "
        f"{(macs / ms) / (eq_macs / eq_ms):.3f}x cuBLAS's int8 rate")
    rm = runs["micro_row_mul"]
    hash_ns = rm["mimc_hash"][0] * 1e6 / Pr.MIMC_SBOXES_PER_HASH
    for layout in Pr.LAYOUTS:
        r = rm[("numbers", layout)]
        log(f"# redesigned sbox_chain {layout} (FP64 product, {r['depth']} deep): {r['slope_us_a_sbox'] * 1e3:.1f} ns "
            f"an S-box, {r['ns_a_dependent_product']:.1f} ns ({r['cycles_a_dependent_product']:.0f} cycles) a "
            f"dependent product, {r['sass_a_product']} SASS a product; parent (CIOS) {PARENT_SBOX_NS[layout]} ns an S-box "
            f"(PERF.md); mimc_hash {hash_ns:.1f} ns an S-box, {hash_ns / 3:.1f} ns a dependent product "
            f"({r['x_mimc_hash_sbox']:.3f}x its S-box)")


def phase_probes(dev) -> dict:
    """Phase 9. Returns per probe its row of the kernels line: launches in
    the run of the scripts' counterparts (counts set to 0 just before it)
    and the numbers of its representative case. Every probe call of the
    phase is held to its plain version (Pr.check), the small cases here
    and each timed case inside the scripts' counterparts."""
    for name, cases in Pr.small_cases(dev).items():
        for args in cases:
            Pr.check(name, getattr(Pr, name)(*args), Pr.PLAIN[name](*args))
        log(f"# probe {name}: equal to its plain version at {len(cases)} small cases")
    Pr.reset_launch_counts()
    runs, seconds = {}, {}
    for script, run in (("micro_ops", Pr.run_micro_ops), ("check_mxu_mul", Pr.run_check_mxu_mul),
                        ("micro_mul_split", Pr.run_micro_mul_split), ("micro_row_mul", Pr.run_micro_row_mul),
                        ("micro_pe_mxu", Pr.run_micro_pe_mxu)):
        t0 = time.perf_counter()
        runs[script] = run()
        seconds[script] = round(time.perf_counter() - t0, 2)
    log(f"# phase 9 seconds by script: {json.dumps(seconds)}")
    launches = dict(Pr.PROBE_LAUNCHES)
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"probes not launched by the scripts' counterparts: {missing}")
    log(f"# launches in phase 9: {json.dumps(launches)}")
    # the representative case of each probe: the production multiply or the
    # scripts' first body, at the scripts' default shapes
    picked = {"op_chain": runs["micro_ops"]["u32 mul"], "imma_dot": runs["micro_ops"]["imma_dot"],
              "field_check": runs["check_mxu_mul"]["mul"], "mul_chain": runs["micro_mul_split"]["mul"],
              "sbox_chain": runs["micro_row_mul"]["col"], "cipher_pe_variant": runs["micro_pe_mxu"][256]}
    rows = {}
    for name, (ms, args) in picked.items():
        got = getattr(Pr, name)(*args)
        want, plain_ms = time_once(Pr.PLAIN[name], args)
        Pr.check(name, got, want)
        bound_ms, bound_by = probe_bound(name, args)
        # imma_dot's function as one PyTorch call makes it: torch._int_mm(m, x) * reps
        library_ms = runs["micro_ops"]["int_mm"][0] if name == "imma_dot" else None
        rows[name] = {"launches": launches[name], "max_abs_err": Pr.MAX_ERR[name], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        lib = f", torch._int_mm(m, x) * {args[2]}: {library_ms:.4f} ms" if library_ms else ""
        log(f"# probe {name}: {ms:.4f} ms kernel vs {plain_ms:.2f} ms plain, bound {bound_ms:.6f} ms "
            f"({bound_by}), max err {Pr.MAX_ERR[name]}{lib}")
        del got, want
    log_redesigned_probes(runs, rows)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 10: the standalone gadget
# ---------------------------------------------------------------------------

GADGET_PUBLIC = 1 << 16  # public entries at the front of phase 10's batch
# close()'s stages, timed through the callables close() resolves at call time
CLOSE_STAGES = ((gadget_mod.GkrGadget, "get_initial_randomness", "commit + rho"),
                (gadget_mod.circ_mod, "assign", "witness"),
                (gadget_mod.gkr_prover, "prove", "prove"),
                (gadget_mod.gkr_verifier, "verify", "self-verify"),
                (gadget_mod, "proof_to_vec", "serialize"))


@contextmanager
def close_stage_timer(times: dict):
    """Seconds of each stage of GkrGadget.close(), with a synchronise
    before and after each."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in CLOSE_STAGES]

    def timed(fn, stage):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            times[stage] = times.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return run

    for (owner, attr, stage), (_, _, fn) in zip(CLOSE_STAGES, saved):
        setattr(owner, attr, timed(fn, stage))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def gadget_updates(bn: int, dev) -> tuple:
    """A gadget on ``dev`` fed 2^bn - 3 updates (so close() pads) in two
    batches, the first min(2^16, n / 4) public: states are the generator's
    stream at 0, messages the stream at n. -> (gadget, states, msgs, the
    batch's new states)."""
    n = (1 << bn) - 3
    stream = random_fr_array(2 * n)
    states, msgs = stream[:n], stream[n:]
    n_pub = min(GADGET_PUBLIC, n // 4)
    g = GkrGadget(device=dev)
    out = g.update_hasher_batch(states[:n_pub], msgs[:n_pub], public=True)
    out += g.update_hasher_batch(states[n_pub:], msgs[n_pub:])
    return g, states, msgs, out


def gadget_tamper_probes(g, setup, proof, dev) -> None:
    """rho + 1, the first proof element + 1 and the last private output + 1
    must each be rejected."""
    c, store = g.circuit, g.io_store
    k = max(i for i, public in enumerate(store.public) if not public)

    def reject(what, bad_proof):
        try:
            verify_gadget(c, setup, bad_proof, store, dev)
        except (GadgetVerifyError, gkr_verifier.GKRError) as e:
            log(f"# gadget tamper probe ({what}) rejected: {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"gadget: a tampered {what} was accepted")

    reject("rho", dataclasses.replace(proof, initial_randomness=(proof.initial_randomness + 1) % P))
    reject("proof vector", dataclasses.replace(proof, proof_vec=[(proof.proof_vec[0] + 1) % P] + proof.proof_vec[1:]))
    saved = store.outputs[k]
    store.outputs[k] = (saved + 1) % P
    try:
        reject(f"private output {k}", proof)
    finally:
        store.outputs[k] = saved


def gadget_cross_check(bn: int, dev) -> None:
    """One gadget's close() through the kernels, then again through the
    plain twins on the same CUDA tensors: the same proof."""
    g, *_ = gadget_updates(bn, dev)
    setup = g.make_setup()
    proof = g.close(setup, check=True)
    with plain_twins():
        plain = g.close(setup, check=True)
    if plain != proof:
        raise AssertionError(f"gadget bn={bn}: kernel and plain close() differ")
    log(f"# gadget bn={bn}: kernel and plain close() give the same rho, commitment and proof vector "
        f"({len(proof.proof_vec)} elements)")


def phase_gadget(bn: int, dev, card: str) -> dict:
    """Phase 10: GkrGadget at 2^bn hashes through its user entry points
    (update_hasher_batch, make_setup, close, verify_gadget) with the
    native host runtime; the wire vector's size and round trip, three
    tamper probes, the batch's outputs against the host update at sampled
    instances; then the kernel/plain cross-check at bn = 10. Returns the
    stage seconds and the launch counts of the 2^bn run."""
    if not native.available():
        raise AssertionError("phase 10: the native host runtime (native/bn254.cpp) did not build")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times: dict = {}
    sync()
    t0 = time.perf_counter()
    g, states, msgs, out = gadget_updates(bn, dev)
    sync()
    times["batch update"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = g.make_setup()
    times["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with close_stage_timer(times):
        proof = g.close(setup, check=True)
    sync()
    close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_gadget(g.circuit, setup, proof, g.io_store, dev)
    sync()
    times["verify_gadget"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times["close, other (pad, qPrime, input tables, output check)"] = close_s - sum(
        times[stage] for _, _, stage in CLOSE_STAGES)

    c, n = g.circuit, len(states)
    if len(proof.proof_vec) != proof_size(c, bn) or proof.bn != bn:
        raise AssertionError(f"gadget: proof of bN {proof.bn}, {len(proof.proof_vec)} elements, "
                             f"expected bN {bn}, {proof_size(c, bn)}")
    if proof_to_vec(c, proof_from_vec(c, bn, proof.proof_vec, dev)) != proof.proof_vec:
        raise AssertionError("gadget: proof_from_vec -> proof_to_vec changed the vector")
    idx = sampled(n)
    if [out[i] for i in idx] != [mimc_update(states[i], msgs[i]) for i in idx]:
        raise AssertionError("gadget: update_hasher_batch disagrees with the host update")
    gadget_tamper_probes(g, setup, proof, dev)
    expected = expected_launches(bn, "gruen")
    expected["cipher_layer"] = 3 * 91  # the permutation of each of the two batches, and assign's cipher layers
    # the generic witness (assign) in place of mimc_witness
    require_launched(launches, [k for k in PATH_KERNELS["gruen"] if k != "mimc_witness"] + ["cipher_layer"],
                     "the gadget")
    same = all(launches[k] == v for k, v in expected.items())
    log(f"# launches in the gadget run: {json.dumps(launches)}")
    log(f"# expected: {json.dumps(expected)}; {'as expected' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("launches in the gadget run differ from the expected counts")
    total = sum(times.values())
    log(f"# gadget bn={bn} on {card}: {n} updates ({sum(g.io_store.public)} public), "
        f"{len(setup.pub_k_gkr) + len(setup.priv_k_gkr_sigma)} committed io scalars; verified, the three tamper "
        f"probes rejected, the batch equal to the host update at {len(idx)} instances; "
        f"{total:.3f} s in all, {(1 << bn) / total:,.0f} hashes/s (batch update to verify_gadget), "
        f"peak memory {peak_gb:.2f} GB")
    log(f"# gadget stages, s: {json.dumps({k: round(v, 3) for k, v in times.items()})}")
    del g, setup, proof, out
    torch.cuda.empty_cache()
    gadget_cross_check(min(10, bn), dev)
    return {"bn": bn, "times": times, "launches": launches, "peak_gb": peak_gb}


# ---------------------------------------------------------------------------
# Phase 11: the Groth16 pipeline
# ---------------------------------------------------------------------------

PIPELINE_BN = 2  # the shape of tests/test_groth16.py::test_gadget_pipeline_batched_hasher
# the stages timed inside the pipeline, through the callables its modules
# resolve at call time; (owner, attribute, label, runs on the card)
PIPELINE_STAGES = ((incircuit_mod.GadgetCircuit, "solve", "solve", False),
                   (incircuit_mod, "mimc_keyed_permutation_device", "hash hint", True),
                   (incircuit_mod.circ_mod, "assign", "assign", True),
                   (incircuit_mod.gkr_prover, "prove", "GKR prove", True),
                   (incircuit_mod.snark_gkr.Proof, "assert_valid", "in-circuit verifier", False),
                   (groth16_mod, "compute_h", "computeH", False),
                   (native, "msm", "G1 MSMs", False),
                   (native, "msm_g2", "G2 MSM", False))


@contextmanager
def pipeline_stage_timer(times: dict, calls: dict):
    """Seconds of each stage in PIPELINE_STAGES, under the label of the
    stage that called it ("compile: hash hint", "solve: GKR prove", ...;
    the computeH and MSM calls of groth16.prove overlap on threads, each
    timed from its own start to its own end). A card stage synchronises
    before and after. ``calls`` keeps the last arguments and result of
    each card stage."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _, _ in PIPELINE_STAGES]
    outer = ["compile"]
    lock = threading.Lock()

    def timed(fn, label, card):
        def run(*args, **kwargs):
            if card:
                sync()
            if label == "solve":
                outer.append("solve")
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if card:
                    sync()
            finally:
                if label == "solve":
                    outer.pop()
            key = label if label == "solve" else f"{outer[-1]}: {label}"
            with lock:
                times[key] = times.get(key, 0.0) + time.perf_counter() - t0
                if card:
                    calls[label] = (args, out)
            return out
        return run

    for (owner, attr, label, card), (_, _, fn) in zip(PIPELINE_STAGES, saved):
        setattr(owner, attr, timed(fn, label, card))
    try:
        yield outer
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def pipeline_expected_launches(bn: int) -> dict:
    """Every kernel's launches over two traces (compile, solve), each with
    one batched hash hint (91 cipher_layer launches), assign's 91 cipher
    layers and one GKR walk (its single multi_eq build of the identity
    layer's eq table) without the walk's verification, which runs in the
    circuit on the host."""
    walk = {**{name: 0 for name in K.KERNELS}, **expected_launches(bn, "gruen"), "multi_eq": 1}
    return {**{k: 2 * v for k, v in walk.items()}, "cipher_layer": 2 * 2 * 91}


def pipeline_tamper_probes(proof, vk, public_values) -> None:
    """KrsGkrPriv replaced (as tests/test_groth16.py does), the first public
    value + 1 and Ar replaced must each raise Groth16VerifyError."""
    gen = g1.to_jac(g1.GEN)
    bad_public = [(public_values[0] + 1) % P] + list(public_values[1:])
    for what, bad, pub in (("krs_gkr_priv", dataclasses.replace(proof, krs_gkr_priv=g1.scalar_mul(gen, 123)),
                            public_values),
                           ("public value 0 + 1", proof, bad_public),
                           ("ar", dataclasses.replace(proof, ar=g1.scalar_mul(proof.ar, 2)), public_values)):
        try:
            groth16_mod.verify(bad, vk, pub)
        except groth16_mod.Groth16VerifyError as e:
            log(f"# pipeline tamper probe ({what}) rejected: {e}")
        else:
            raise AssertionError(f"pipeline: a tampered {what} was accepted")


def phase_pipeline(bn: int, dev, card: str) -> dict:
    """Phase 11: GadgetCircuit over 2^bn messages hashed by one
    update_hasher_batch (the hints on the card), compile, setup(seed),
    prove(seed), groth16.verify, each stage timed; three tamper probes;
    the solve trace's GKR inputs proven again through the plain twins (the
    same proof vector); the run's launch counts against the expected ones.
    Returns the stage seconds, the R1CS sizes and the launch counts."""
    if not native.available():
        raise AssertionError("phase 11: the native host runtime (native/bn254.cpp) did not build")
    n = 1 << bn
    msgs = random_fr_array(n)

    def define(cs, gadget):
        states = [cs.witness(0) for _ in range(n)]
        gadget.update_hasher_batch(cs, states, [cs.witness(m) for m in msgs])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times: dict = {}
    calls: dict = {}
    with pipeline_stage_timer(times, calls) as outer:
        t0 = time.perf_counter()
        circ = GadgetCircuit(define, device=dev)
        compiled = circ.compile()
        times["compile"] = time.perf_counter() - t0
        r1cs = compiled.r1cs
        sizes = {"constraints": len(r1cs.constraints), "wires": r1cs.n_wires, "public": r1cs.n_public,
                 "bn": compiled.bn, "partition (pub gkr, priv gkr, pub not gkr, priv not gkr)":
                 [len(p) for p in compiled.partition]}
        log(f"# pipeline bN={bn}: R1CS {json.dumps(sizes)}")
        if compiled.bn != bn:
            raise AssertionError(f"pipeline: compiled bN {compiled.bn}, expected {bn}")
        outer[-1] = "setup"
        t0 = time.perf_counter()
        pk, vk = incircuit_mod.setup(compiled, seed=b"chip-smoke-pipeline")
        times["setup"] = time.perf_counter() - t0
        outer[-1] = "groth16.prove"
        t0 = time.perf_counter()
        proof, public_values = circ.prove(compiled, pk, vk, seed=b"chip-smoke-prove")
        times["prove (solve and groth16.prove)"] = time.perf_counter() - t0
        outer[-1] = "verify"
        t0 = time.perf_counter()
        groth16_mod.verify(proof, vk, public_values)
        times["verify"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if proof.initial_randomness != public_values[0] or proof.initial_randomness == 0:
        raise AssertionError("pipeline: the proof's rho is not the first public value")
    pipeline_tamper_probes(proof, vk, public_values)

    # the solve trace's GKR inputs, proven again through the plain twins
    (c, inputs), a = calls["assign"]
    (_, _, qprime), gkr_proof = calls["GKR prove"]
    want = proof_to_vec(c, gkr_proof)
    with plain_twins():
        plain = proof_to_vec(c, gkr_prover.prove(c, assign(c, inputs), qprime))
    if plain != want:
        raise AssertionError("pipeline: the plain twins' GKR proof differs from the kernels'")
    del a, gkr_proof, calls

    expected = pipeline_expected_launches(bn)
    require_launched(launches, ["cipher_layer", "tail_rounds"], "the pipeline")
    same = launches == expected
    log(f"# launches in the pipeline run: {json.dumps(launches)}")
    log(f"# expected: {json.dumps(expected)}; {'as expected' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("launches in the pipeline run differ from the expected counts")
    total = sum(v for k, v in times.items() if ":" not in k and k != "solve")
    log(f"# pipeline bN={bn} on {card}: {n} hashes, verified, the three tamper probes rejected, the solve's GKR "
        f"proof equal through the plain twins ({len(want)} elements); {total:.3f} s compile to verify, peak "
        f"device memory {peak_gb:.4f} GB")
    log(f"# pipeline stages, s: {json.dumps({k: round(v, 3) for k, v in times.items()})}")
    return {"bn": bn, "times": times, "sizes": sizes, "launches": launches, "peak_gb": peak_gb}


# ---------------------------------------------------------------------------
# Phase 12: the sharded walk
# ---------------------------------------------------------------------------

SHARDED_RANK_TIMEOUT_S = 420  # a rank of phase 12b, bring-up to exit


def expected_sharded_launches(bn: int, world: int, verified: bool) -> dict:
    """Launches of one rank's sharded "coeff" walk at 2^bn over `world`
    ranks: every layer's log2(2^bn / world) local rounds on the kernels
    (round sums, hash, one fold), then, with more than one rank, one
    tail_rounds launch on the gathered tables; the single-claim eq tables
    by the contraction from 2^13 local entries; the verifier folds the
    output and the two input tables once per variable."""
    local = bn - (world.bit_length() - 1)
    return {"mimc_witness": 1, "cipher_coeff_acc": 91 * local, "identity_acc": local,
            "fold": 92 * local + (3 * bn if verified else 0), "mimc_hash": 92 * local + 1,
            "multi_eq": 92 if local >= sumcheck_prover.MULTI_EQ_MIN_BITS else 1,
            "tail_rounds": 92 if world > 1 else 0, "gruen_acc": 0, "gruen_round_scalar": 0,
            "suffix_step": 0, "cipher_layer": 0}


def phase_sharded_single(bn: int, want_vec: list, dev, card: str) -> dict:
    """12a: world size 1 on nccl in this process: the rank's slab of the
    inputs (the whole table), the witness, the sharded "coeff" walk (every
    round local, then no gather), verified with the unsharded tables, a
    tamper probe, phase 5's proof vector."""
    c = mimc_circuit()
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend="nccl")
    try:
        m = multihost.make_global_mesh(backend="nccl")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        block = multihost.shard_mimc_inputs_global(m, 1 << bn)
        state = block.clone()
        qprime = ints_to_rows(random_fr_array(bn), dev)
        sync()
        t1 = time.perf_counter()
        a = pmesh.assign_sharded_mimc(block, state)
        sync()
        t2 = time.perf_counter()
        proof = pmesh.prove_gkr_sharded(c, a, qprime, m)
        sync()
        t3 = time.perf_counter()
        tables = [pmesh.unshard_table([t]) for t in (block, state, a[93])]
        gkr_verifier.verify(c, proof, tables[:2], tables[2], qprime)
        launches = dict(K.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if proof_to_vec(c, proof) != want_vec:
            raise AssertionError(f"bn={bn}: the sharded walk at world size 1 differs from phase 5's proof vector")
        tamper_probe(c, proof, tables[0], tables[1], a, qprime, "sharded world size 1")
        log(f"# sharded walk, world size 1 ({m.backend}, {m.device}) bn={bn} on {card}: phase 5's proof vector, "
            f"verified; inputs {t1 - t0:.3f} s, witness {t2 - t1:.3f} s, prove {t3 - t2:.3f} s, "
            f"{m.counts['all_reduce']} all-reduces, {m.counts['all_gather']} all-gathers, peak memory {peak_gb:.2f} GB")
        report_launches(launches, expected_sharded_launches(bn, 1, True), "the sharded walk, world size 1")
        return {"prove_s": t3 - t2, "launches": launches, "collectives": dict(m.counts), "peak_gb": peak_gb}
    finally:
        torch.distributed.destroy_process_group()


def phase_sharded_ranks(bn: int, want_vec: list, world: int = 2) -> dict:
    """12b: `world` ranks started by this script on the one card, gloo
    (nccl refuses two ranks on one device), each building only its slab of
    phase 5's inputs; rank 0's proof vector must be phase 5's. A rank that
    fails or outlives its time limit fails the phase with its output."""
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        vec_out = os.path.join(tmp, "vec.json")
        t0 = time.perf_counter()
        outs = multihost.launch_local(world, ["-m", "gkr_mimc_tpu_torch.parallel.mesh", "--bn", str(bn),
                                              "--backend", "gloo", "--device", "cuda", "--vec-out", vec_out],
                                      SHARDED_RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        with open(vec_out) as f:
            vec = json.load(f)
    reports = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    if vec != [str(v) for v in want_vec]:
        raise AssertionError(f"bn={bn}: rank 0 of the {world}-rank sharded walk differs from phase 5's proof vector")
    if len({r["vec_sha256"] for r in reports}) != 1:
        raise AssertionError("the ranks' proof vectors differ")
    for r in reports:
        log(f"# sharded walk rank {r['rank']} of {r['world']} ({r['backend']}, {r['device']}) bn={bn}: exit 0, "
            f"bring-up {r['bring_up_s']:.3f} s, inputs {r['inputs_s']:.3f} s, witness {r['witness_s']:.3f} s, "
            f"prove {r['prove_s'][0]:.3f} s, {r['collectives']['all_reduce']} all-reduces, "
            f"{r['collectives']['all_gather']} all-gathers, peak memory {r.get('peak_gb', 0.0):.2f} GB")
        report_launches(r["launches"], expected_sharded_launches(bn, world, False), f"sharded rank {r['rank']}")
    log(f"# sharded walk, world size {world} on one card: rank 0's proof vector is phase 5's; {wall:.1f} s from "
        f"start to the last rank's exit")
    return {"reports": reports, "wall_s": wall}


def phase_sharded(bn: int, want_vec: list, dev, card: str) -> dict:
    """Phase 12: the sharded walk at world size 1 in this process (12a),
    then 2 ranks on the one card (12b)."""
    single = phase_sharded_single(bn, want_vec, dev, card)
    return {"single": single, "ranks": phase_sharded_ranks(bn, want_vec)}


# ---------------------------------------------------------------------------
# Phase 13: the checkpointed witness and the profiler
# ---------------------------------------------------------------------------

RESIDENT_TABLES = 94  # the MiMC witness, every layer's table


def checkpointed_walk(bn: int, dev, card: str, what: str) -> tuple:
    """Inputs on the card, the checkpointed witness (stride 13), the
    default walk, each stage under the ported Timer; returns (circuit,
    inputs, witness, proof, seconds by stage, peak GB)."""
    c = mimc_circuit()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with profiling.Timer(f"# {what}: inputs", out=sys.stdout) as t_in:
        block, state, qprime = t_in.sync_on(walk_inputs(bn, dev))
    with profiling.Timer(f"# {what}: checkpointed witness", out=sys.stdout) as t_wit:
        ck = CheckpointedAssignment(block, state)
        t_wit.sync_on(ck.output)
    with profiling.Timer(f"# {what}: prove", out=sys.stdout) as t_prove:
        proof = gkr_prover.prove(c, ck, qprime)
        t_prove.sync_on([p.coeffs for p in proof.sumcheck_proofs if p is not None])
    times = {"inputs_s": t_in.elapsed_ms / 1e3, "witness_s": t_wit.elapsed_ms / 1e3, "prove_s": t_prove.elapsed_ms / 1e3}
    return c, block, state, qprime, ck, proof, times, torch.cuda.max_memory_allocated() / 1e9


def phase_checkpoint(bn: int, want_vec: list, main_peak_gb: float, dev, card: str) -> dict:
    """Phase 13: (a) the checkpointed witness at --bn gives phase 5's proof
    vector; (b) 2^(bn+3) hashes, more than a resident witness fits on the
    card, proven, verified, a tamper probe, the outputs at sampled
    instances; (c) profile_trace around a bn = 12 walk."""
    c, block, state, qprime, ck, proof, times, peak_a = checkpointed_walk(bn, dev, card, f"13a bn={bn}")
    if proof_to_vec(c, proof) != want_vec:
        raise AssertionError(f"bn={bn}: the checkpointed walk differs from phase 5's proof vector")
    n_spans = ck.n_spans
    log(f"# checkpointed walk bn={bn} on {card}: phase 5's proof vector; witness {times['witness_s']:.3f} s, prove "
        f"{times['prove_s']:.3f} s, peak memory {peak_a:.2f} GB (phase 5, resident: {main_peak_gb:.2f} GB)")
    del c, block, state, qprime, ck, proof

    big = bn + 3
    resident_gb = RESIDENT_TABLES * (1 << big) * FE / 1e9
    c, block, state, qprime, ck, proof, times_b, peak_b = checkpointed_walk(big, dev, card, f"13b bn={big}")
    launches = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    gkr_verifier.verify(c, proof, [block, state], ck[93], qprime)
    sync()
    verify_s = time.perf_counter() - t0
    check_outputs(ck[93], 0, 0, 1 << big, f"checkpointed bn={big}")
    tamper_probe(c, proof, block, state, ck, qprime, f"checkpointed bn={big}")
    # every span made twice (the forward pass, the walk's read), the last once
    report_launches(launches, dict(expected_launches(big, "gruen"), mimc_witness=2 * n_spans - 1),
                    f"the checkpointed walk at bn={big}")
    hps = (1 << big) / (times_b["witness_s"] + times_b["prove_s"])
    log(f"# checkpointed walk bn={big} ({1 << big:,} hashes) on {card}: verified, tamper rejected, outputs equal "
        f"the host permutation; inputs {times_b['inputs_s']:.3f} s, witness {times_b['witness_s']:.3f} s, prove "
        f"{times_b['prove_s']:.3f} s, verify {verify_s:.3f} s, {hps:,.0f} hashes proven/s (witness + prove), "
        f"peak memory {peak_b:.2f} GB; a resident witness at this bn needs {RESIDENT_TABLES} x 2^{big} x {FE} B = "
        f"{resident_gb:.1f} GB, more than the card's 80 GB, so no resident run compares")
    del c, block, state, qprime, ck, proof

    trace = phase_profile_trace(12, dev)
    return {"a": {**times, "peak_gb": peak_a}, "b": {**times_b, "verify_s": verify_s, "peak_gb": peak_b,
                                                     "hps": hps, "launches": launches}, "c": trace}


def port_kernel_names() -> set:
    """The __global__ functions of the port's CUDA sources."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?(?:void\s+)?(\w+)\s*\(")
    return {m.group(1) for src in build.sources() for m in pat.finditer(src.read_text())}


def phase_profile_trace(bn: int, dev) -> dict:
    """13c: ``profile_trace`` around a bn walk (inputs, witness, prove);
    the Chrome trace must hold kernel events of the port's kernels."""
    c = mimc_circuit()
    K.reset_launch_counts()
    with profiling.profile_trace("chip_smoke_13c", root=str(ROOT / "profiling")) as path:
        block, state, qprime = walk_inputs(bn, dev)
        gkr_prover.prove(c, assign_fused(block, state), qprime)
    launched = sum(K.LAUNCHES.values())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = port_kernel_names()
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ours = {}
    for k in kernels:
        for name in names:
            if re.search(rf"\b{name}\b", k):
                ours[name] = ours.get(name, 0) + 1
    size = os.path.getsize(path)
    log(f"# profile_trace bn={bn}: {path} ({size:,} B), {len(events):,} events, {len(kernels):,} kernel events, "
        f"{sum(ours.values()):,} of the port's kernels ({launched:,} launches counted): {json.dumps(ours)}")
    if not ours:
        raise AssertionError("the trace holds no kernel event of the port's kernels")
    return {"bytes": size, "events": len(events), "kernel_events": len(kernels), "port_kernels": ours}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bn", type=int, default=22, help="log2 of the hashes proven on the main path")
    bn = ap.parse_args().bn
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # 1. toolchain and card
    card = card_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"# nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"# card: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native_build = pool.submit(native.build)  # g++ of phase 10's host runtime beside the nvcc builds
        build.library()
        log(f"# kernels built in {time.perf_counter() - t0:.1f} s -> {build.library_path().name}")
        log(f"# native host runtime built beside them -> {native_build.result().name} "
            f"({time.perf_counter() - t0:.1f} s)")
    report = Path(f"{build.library_path()}.log")
    if report.exists():
        text = report.read_text()
        for line in text.splitlines():
            if line.startswith("== ") or "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"#   ptxas {line.split('ptxas info    :')[-1].strip()}")
        for fn, use in ptxas_usage(text).items():
            if any(key in fn for key in REGISTER_WATCH):
                log(f"# registers {fn}: {json.dumps(use)}")
    log_sass()

    phase_s = {"1": time.perf_counter() - start}
    mark = time.perf_counter()

    def done(phase: str) -> None:
        nonlocal mark
        phase_s[phase] = phase_s.get(phase, 0.0) + time.perf_counter() - mark
        mark = time.perf_counter()

    kernel_results = phase_kernels(bn, dev)  # 2.
    done("2")
    phase_golden(dev)  # 3.
    done("3")
    # 4. and 8. are cut in depth so that the script ends inside its limit on
    # a slow host: they move with the host's speed, the card's phases do not
    # (PERF.md, section 4)
    phase_cross_check(min(13, bn), dev)  # 4.
    phase_grouped_cross_check(min(10, bn - 2), 2, dev)
    small = phase_round_paths_small(min(10, bn), min(8, bn - 2), 2, dev)
    done("4")
    main_run = phase_main(bn, dev, card)  # 5.
    done("5")
    paths = phase_round_paths_main(bn, main_run, dev, card)  # 7., while phase 5's witness is resident
    done("7")
    launches, main_vec = main_run["launches"], main_run["vec"]
    main_peak_gb = main_run["peak_gb"]
    del main_run
    phase_sharded(bn, main_vec, dev, card)  # 12., while phase 5's proof vector is held
    done("12")
    phase_checkpoint(bn, main_vec, main_peak_gb, dev, card)  # 13.
    done("13")
    del main_vec
    phase_grouped(bn - 2, GROUPS, dev, card)  # 6.
    done("6")
    # 8. Poseidon's 397 layers at bn - 8: their tail rounds cost the same at every bn
    circuits = phase_circuits(bn - 2, bn - 8, dev, card)
    done("8")
    probes = phase_probes(dev)  # 9.
    done("9")
    phase_gadget(bn - 4, dev, card)  # 10. 2^18 hashes at the default --bn
    done("10")
    phase_pipeline(PIPELINE_BN, dev, card)  # 11.
    done("11")

    # each kernel's launches from the run of the path that runs it
    counted_on = {"cipher_coeff_acc": ("phase 7 coeff", paths["coeff"]),
                  "cipher_partial_evals": ("phase 7 evals", paths["evals"]),
                  "identity_partial_evals": ("phase 7 evals", paths["evals"]),
                  "mul_scalar": (f"phase 4 coeff, bn={min(10, bn)}", small["coeff"]),
                  "pow7": ("phase 8", circuits["launches"]),
                  "cipher_layer": ("phase 8", circuits["launches"])}
    kernels = []
    for name, (source, replaces) in K.KERNELS.items():
        where, counts = counted_on.get(name, ("phase 5", launches))
        log(f"# launches of {name}: {counts[name]} ({where})")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], **kernel_results[name]})
    for name, (source, replaces) in Pr.PROBES.items():
        log(f"# launches of {name}: {probes[name]['launches']} (phase 9)")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, **probes[name]})
    log(f"# seconds by phase: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(f"# chip_smoke total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
