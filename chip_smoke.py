"""Smoke run of the PyTorch + CUDA port (gkr_mimc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--bn 22]

Builds the CUDA kernels from gkr_mimc_tpu_torch/csrc at first use (one
nvcc per source, in parallel), then:

1. toolchain and card: torch, CUDA, nvcc, the card's name and power limit,
   the build time and nvcc's register report, with a summary line of the
   registers, spills and shared memory of the cipher rounds' deferred
   pass 1 (one and two weight rows), its two finishers and the hash-chain
   kernels (the tail rounds' two gates among them);
2. every kernel against its plain torch twin on the card, bit for bit, at
   small shapes (G = 1, 2, 4; both claim-trick settings of the partial
   evaluations; the fold at 3 tables; multi_eq at one claim; the S-boxes
   and the three cipher rounds at the lazy representatives' edges; the
   cipher rounds where a block sums more points than one flush interval of
   their digit sums; the tail rounds of both gates at G = 1 and 4, at the
   main path's 2^8 entries, a single round, the largest tail and the lazy
   edges) and
   at the main path's shapes (timed, kernel and plain, beside the least
   time the card could take for the same work), some also at a second
   shape; the hash chain's ns a product, and the tail rounds' chain floor
   (log2(m) hashes of their coefficients);
3. golden transcripts: MimcHash([12]) and tests/golden/transcripts.json,
   with tail_bits 8 and 1;
4. a full GKR walk at bn = 14 and a grouped walk of G = 2 instances at
   bn = 12, each through the kernels and again through the plain twins on
   the same CUDA tensors: identical proof vectors; each grouped lane
   equals the single-instance walk of its inputs. Then the two other round
   paths, rounds="coeff" and rounds="evals", at tail_bits 2: a walk at
   bn = 12 (its eq tables built through mul_scalar) equal to the default
   "gruen" walk, and G = 2 lanes at bn = 10 each equal to the gruen walk
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
8. the other circuits: GMiMC T2 (96 layers) at bn = --bn and Poseidon T2
   (RF 8, RP 82: 397 layers) at bn = --bn - 4, each through the generic
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
   op rates and the tensor-core dot (beside torch._int_mm(m, x) * reps),
   check_mxu_mul's field check of both multiplies, the Montgomery-product
   split, the S-box chain latency in both layouts, the partial-evals
   multiply A/B.

Each path's launch counts are read from its own run, the counts set to 0
just before it: the kernels of the default path from phase 5,
cipher_coeff_acc from phase 7's coeff run, the partial evaluations from
its evals run, mul_scalar (which builds single-claim eq tables below
2^13 entries only) from phase 4's coeff walk at bn = 12, pow7 (the
hashers' S-box) and cipher_layer (the generic witness's cipher layers;
the MiMC walk runs its tails, gate included, in tail_rounds) from phase
8, and the six probes from phase 9's run of the scripts' counterparts.

Prints one JSON line of per-kernel results, then the nvidia-smi line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero on any
failure, including when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gkr_mimc_tpu_torch.circuits.circuit import assign  # noqa: E402
from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.fields.bn254 import L, P  # noqa: E402
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec  # noqa: E402
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover  # noqa: E402
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier  # noqa: E402
from gkr_mimc_tpu_torch.hashes import gmimc as gmimc_hash  # noqa: E402
from gkr_mimc_tpu_torch.hashes import poseidon as poseidon_hash  # noqa: E402
from gkr_mimc_tpu_torch.hashes.ark import arks_mont  # noqa: E402
from gkr_mimc_tpu_torch.hashes.mimc import mimc_hash, mimc_hash_device, mimc_keyed_permutation  # noqa: E402
from gkr_mimc_tpu_torch.models import gmimc, poseidon  # noqa: E402
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit  # noqa: E402
from gkr_mimc_tpu_torch.ops import build  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402
from gkr_mimc_tpu_torch.ops import probes as Pr  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import prover as sumcheck_prover  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import testing  # noqa: E402
from gkr_mimc_tpu_torch.utils.common import grouped_inputs, random_fr_array, random_fr_device  # noqa: E402
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
DEFERRED_FULL, DEFERRED_WIDE, WIDE_RESULTS, DEFERRED_MACS = 9, 8, 128, 32 * 512
WEIGHT_ROWS = {"gruen_acc": 1, "cipher_coeff_acc": 2, "cipher_partial_evals": 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# kernels whose registers, spills and shared memory phase 1 logs by name
# (parts of their mangled names): the cipher rounds' deferred pass 1 (both
# instantiations) and its finishers, and the hash-chain kernels (the tail
# rounds' both gates among them)
REGISTER_WATCH = ("8deferred10acc_kernel", "8deferred19gruen_finish_kernel", "8deferred19coeff_finish_kernel",
                  "gruen_round_kernel", "mimc_hash_kernel", "tail_kernel")


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
    (IMMA) and shuffle instructions of the loop. Fails if an instantiation
    of the cipher rounds' pass 1 has no IMMA in its tile loop."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())], capture_output=True, text=True,
                          check=True).stdout
    for fn, (loop, whole) in Pr.sass_loops(text).items():
        if not any(key in fn for key in REGISTER_WATCH):
            continue
        imma = sum(op.startswith("IMMA") for op in loop)
        shfl = sum(op.startswith("SHFL") for op in loop)
        log(f"# sass {fn}: {len(whole)} instructions, largest loop {len(loop)} ({imma} IMMA, {shfl} SHFL)")
        if REGISTER_WATCH[0] in fn and imma == 0:
            raise AssertionError(f"{fn}: no IMMA in its tile loop")


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
        # the list of each cipher round)
        ("gruen_acc", [acc_args(1, 2), acc_args(4, 2), acc_args(2, 128), acc_args(1, 1 << 16),
                       acc_args(4, 1 << 12)] + gruen_edges + [acc_args(GROUPS, n // GROUPS)],
         lambda: acc_args(1, n)),
        ("cipher_coeff_acc", [coeff_args(1, 2), coeff_args(2, 2), coeff_args(4, 8), coeff_args(1, 1 << 16),
                              coeff_args(2, 1 << 10), coeff_args(4, 1 << 12)] + direct_edges
         + [coeff_args(GROUPS, n // GROUPS)],
         lambda: coeff_args(1, n)),
        ("identity_acc", [(r(2), r(2), 1), (r(8), r(8), 4), (r(1 << 16), r(1 << 16), 1),
                          (r(4 << 12), r(4 << 12), 4)],
         lambda: (r(n), r(n), 1)),
        ("cipher_partial_evals", [cpe_args(g, m, skip) for g, m in ((1, 2), (2, 8), (4, 1 << 12), (1, 1 << 16))
                                  for skip in (False, True)]
         + [e + (K.CIPHER_EVALS, skip) for e in direct_edges for skip in (False, True)]
         + [cpe_args(GROUPS, n // GROUPS, True)],
         lambda: cpe_args(1, n, True)),
        ("identity_partial_evals", [ipe_args(g, m, skip) for g, m in ((1, 2), (2, 8), (4, 1 << 12), (1, 1 << 16))
                                    for skip in (False, True)],
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
    if name == "identity_acc":
        eq, _, g = args
        return FE * (2 * eq.shape[-1] + 3 * g), 4 * (eq.shape[-1] // 2)
    # cipher_evals_per_t: the cipher round at every t, cipher_pe_variant's design
    if name in ("cipher_evals_per_t", "identity_partial_evals"):
        eq, g, n_evals, skip = args[0], args[-3], args[-2], args[-1]
        n_out, n_tables = n_evals - bool(skip), (3 if name.startswith("cipher") else 2)
        per_t = 5 if name.startswith("cipher") else 1  # x^7 and the eq weight, or the eq weight
        return FE * (n_tables * eq.shape[-1] + (g if n_tables == 3 else 0) + n_out * g), per_t * n_out * (eq.shape[-1] // 2)
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
# main path's shapes (cipher_partial_evals: t = 1..8, 5 a t)
OLD_PRODUCTS = {"gruen_acc": 25, "cipher_coeff_acc": 33, "cipher_partial_evals": 40}


def log_deferred(name: str, bn: int, flush_case) -> None:
    """The bound of the design before the deferred one, and how many points
    a block of the flush-interval case sums."""
    old_ms = OLD_PRODUCTS[name] * (1 << (bn - 1)) * MULS_PER_PRODUCT / INT_MULS_PER_S * 1e3
    if name == "gruen_acc":
        g = flush_case[3].shape[-1]
        half = flush_case[0].shape[-1] // g
    else:
        g = flush_case[4]
        half = flush_case[0].shape[-1] // g // 2
    tiles = -(-half // K.DEFERRED_TILE)
    bpg = K._deferred_blocks(half, g, flush_case[0].device)
    log(f"# kernel {name}: bound of the {OLD_PRODUCTS[name]}-product design at the main shapes {old_ms:.6f} ms "
        f"(operations); G={g} x 2^{half.bit_length() - 1} points case: a block sums up to "
        f"{-(-tiles // bpg) * K.DEFERRED_TILE} points (s32 digit sums flushed every {K.DEFERRED_FLUSH_POINTS})")


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


def report_launches(launches: dict, bn: int, rounds: str, what: str) -> None:
    expected = expected_launches(bn, rounds)
    same = all(launches[k] == v for k, v in expected.items())
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
    report_launches(launches, bn, "gruen", "the main path")
    main = {"c": c, "block": block, "state": state, "qprime": qprime, "a": a, "times": times,
            "vec": proof_to_vec(c, proof), "launches": launches}
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
        report_launches(launches[rounds], bn, rounds, f"the {rounds} path")
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
    runs = {"micro_ops": Pr.run_micro_ops(), "check_mxu_mul": Pr.run_check_mxu_mul(),
            "micro_mul_split": Pr.run_micro_mul_split(), "micro_row_mul": Pr.run_micro_row_mul(),
            "micro_pe_mxu": Pr.run_micro_pe_mxu()}
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
    torch.cuda.empty_cache()
    return rows


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
    build.library()
    log(f"# kernels built in {time.perf_counter() - t0:.1f} s -> {build.library_path().name}")
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
    phase_cross_check(min(14, bn), dev)  # 4.
    phase_grouped_cross_check(min(12, bn - 2), 2, dev)
    small = phase_round_paths_small(min(12, bn), min(10, bn - 2), 2, dev)
    done("4")
    main_run = phase_main(bn, dev, card)  # 5.
    done("5")
    paths = phase_round_paths_main(bn, main_run, dev, card)  # 7., while phase 5's witness is resident
    done("7")
    launches = main_run["launches"]
    del main_run
    phase_grouped(bn - 2, GROUPS, dev, card)  # 6.
    done("6")
    # 8. Poseidon's 397 layers at bn - 4: their tail rounds cost the same at every bn
    circuits = phase_circuits(bn, bn - 4, dev, card)
    done("8")
    probes = phase_probes(dev)  # 9.
    done("9")

    # each kernel's launches from the run of the path that runs it
    counted_on = {"cipher_coeff_acc": ("phase 7 coeff", paths["coeff"]),
                  "cipher_partial_evals": ("phase 7 evals", paths["evals"]),
                  "identity_partial_evals": ("phase 7 evals", paths["evals"]),
                  "mul_scalar": (f"phase 4 coeff, bn={min(12, bn)}", small["coeff"]),
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
