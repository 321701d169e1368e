"""Smoke run of the PyTorch + CUDA port (gkr_mimc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--bn 22]

Builds the CUDA kernels from gkr_mimc_tpu_torch/csrc at first use, then:

1. toolchain and card: torch, CUDA, nvcc, the card's name and power limit,
   the build time and nvcc's register report;
2. every kernel against its plain torch twin on the card, bit for bit, at
   small shapes and at the main path's shapes (timed, kernel and plain,
   beside the least time the card could take for the same work);
3. golden transcripts: MimcHash([12]) and tests/golden/transcripts.json,
   with tail_bits 8 and 1;
4. a full GKR walk at bn = 14 and a grouped walk of G = 2 instances at
   bn = 12, each through the kernels and again through the plain twins on
   the same CUDA tensors: identical proof vectors; each grouped lane
   equals the single-instance walk of its inputs;
5. the main path at --bn (default 22, the north-star size): inputs
   generated on the card, witness, GKR proof, verification, a tamper probe,
   and the launch count of every kernel during that run;
6. the grouped path, G = 4 instances at bn = --bn - 2 (as many hashes as
   the main path): inputs on the card, witness, grouped proof,
   verify_grouped, a tamper probe in lane 2 that must be named, and the
   launch counts of that run.

Prints one JSON line of per-kernel results, then the nvidia-smi line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero on any
failure, including when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.fields.bn254 import L  # noqa: E402
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec  # noqa: E402
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover  # noqa: E402
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier  # noqa: E402
from gkr_mimc_tpu_torch.hashes.ark import arks_mont  # noqa: E402
from gkr_mimc_tpu_torch.hashes.mimc import mimc_hash, mimc_hash_device, mimc_keyed_permutation  # noqa: E402
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit  # noqa: E402
from gkr_mimc_tpu_torch.ops import build  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402
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
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_PRODUCT = 264
FE = 32  # bytes per field element


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def sync() -> None:
    torch.cuda.synchronize()


def rand_lazy(rng: np.random.Generator, shape, dev) -> torch.Tensor:
    """Field tables of lazy representatives (< 2p) from a numpy seed."""
    limbs = rng.integers(0, 1 << 32, size=(L,) + tuple(shape), dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


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

    def fold_args(nt, g, n_):
        return ([r(g * n_) for _ in range(nt)], r(g))

    def acc_args(g, n_):
        return (r(g * n_ // 2), r(g * n_), r(g * n_), r(g))

    def eq_args(c, j, b):  # mh (C, 8, J), lo (8, J, B)
        return (r(c, j).permute(1, 0, 2).contiguous(), r(j, b))

    def round_args(g):  # Q (8, 8, G); alpha, beta, ck, q_k (8, G)
        return (r(8, g), r(g), r(g), r(g), r(g))

    return [
        ("mimc_witness", [(r(2), r(2), arks), (r(1 << 16), r(1 << 16), arks)],
         lambda: (r(n), r(n), arks)),
        ("mimc_hash", [(r(1),), (r(3),), (r(9),)], lambda: (r(9),)),
        ("mimc_hash_g", [(r(9, 1),), (r(9, 2048),)], lambda: (r(9, 91 * bn),)),
        ("fold", [fold_args(1, 1, 2), fold_args(2, 4, 2), fold_args(4, 1, 8),
                  fold_args(2, 1, 1 << 16), fold_args(1, 4, 1 << 14)],
         lambda: fold_args(2, 1, n)),
        ("suffix_step", [(r(1), r(1)), (r(4 * 2), r(4)), (r(1 << 15), r(1)), (r(4 << 13), r(4))],
         lambda: (r(n // 4), r(1))),
        ("multi_eq", [eq_args(1, 10, 8), eq_args(3, 5, 2), eq_args(64, 91, 1 << 10)],
         lambda: eq_args(max(1, n >> 10), 91, min(n, 1 << 10))),
        ("gruen_acc", [acc_args(1, 2), acc_args(4, 2), acc_args(1, 1 << 16), acc_args(4, 1 << 12)],
         lambda: acc_args(1, n)),
        ("identity_acc", [(r(2), r(2), 1), (r(8), r(8), 4), (r(1 << 16), r(1 << 16), 1),
                          (r(4 << 12), r(4 << 12), 4)],
         lambda: (r(n), r(n), 1)),
        ("gruen_round_scalar", [round_args(1), round_args(2), round_args(4), round_args(2048)],
         lambda: round_args(1)),
    ]


# Extra shapes timed beside the main one (name -> label, args factory).
def extra_timings(dev, rng):
    def r(*shape):
        return rand_lazy(rng, shape, dev)

    return {"gruen_round_scalar": ("G = 4", lambda: (r(8, GROUPS),) + tuple(r(GROUPS) for _ in range(4)))}


def work(name: str, args) -> tuple[int, int]:
    """(bytes moved, Montgomery products) of one call: each input read and
    each output written once."""
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
    if name == "gruen_acc":
        s_, x0, _, ark = args
        half, g = s_.shape[-1], ark.shape[-1]
        return FE * (half + 4 * half + g + 8 * g), 25 * half + 8 * g
    if name == "identity_acc":
        eq, _, g = args
        return FE * (2 * eq.shape[-1] + 3 * g), 4 * (eq.shape[-1] // 2)
    if name == "gruen_round_scalar":
        g = args[0].shape[-1]
        # combine 16 + 9, hash 9 words x 91 rounds x 4, eq1 and ck' 2
        return FE * (12 * g + K.MIMC_ROUNDS + 11 * g), (25 + 9 * 4 * K.MIMC_ROUNDS + 2) * g
    raise KeyError(name)


def bound(name: str, args) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    nbytes, products = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * MULS_PER_PRODUCT / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(bn: int, dev) -> dict:
    rng = np.random.default_rng(2024)
    results = {}
    extras = extra_timings(dev, rng)
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
        del got, want, args
        torch.cuda.empty_cache()
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
        log(f"# kernel {name}: bit-equal to plain; {ms:.4f} ms kernel vs {plain_ms:.2f} ms plain, "
            f"bound {bound_ms:.6f} ms ({bound_by}) at the bn={bn} main-path shapes")
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


def walk(bn: int, dev):
    """Inputs on the card -> witness -> proof; returns timings and artifacts."""
    n = 1 << bn
    c = mimc_circuit()
    sync()
    t0 = time.perf_counter()
    block = fr.to_mont(random_fr_device(n, 0, dev))
    state = block.clone()
    qprime = ints_to_rows(random_fr_array(bn), dev)
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
    tail_bits put nearly every round on the kernels (fused head rounds at
    G lanes); the plain-torch tail rounds, not the kernels, set the time
    of a walk, and the transcript does not depend on the split."""
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


def phase_main(bn: int, dev, card: str) -> dict:
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

    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    check_outputs(a[93], 0, 0, 1 << bn, "main path")  # block = state = the stream at 0
    # tamper probe: one flipped coefficient bit must be rejected
    bad = proof.sumcheck_proofs[50].coeffs.clone()
    bad[0, 0, 0] ^= 1
    good = proof.sumcheck_proofs[50].coeffs
    proof.sumcheck_proofs[50].coeffs = bad
    try:
        gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
    except gkr_verifier.GKRError as e:
        log(f"# tamper probe rejected: {e}")
    else:
        raise AssertionError("a tampered proof was accepted")
    proof.sumcheck_proofs[50].coeffs = good

    n = 1 << bn
    hps = n / (times["witness_s"] + times["prove_s"])
    log(f"# main path bn={bn} on {card}: inputs {times['inputs_s']:.3f} s, witness "
        f"{times['witness_s']:.3f} s, prove {times['prove_s']:.3f} s, verify {times['verify_s']:.3f} s, "
        f"{hps:,.0f} hashes proven/s (witness + prove), peak memory {peak_gb:.2f} GB")
    log(f"# launches on the main path: {json.dumps(launches)}")
    head = max(0, bn - sumcheck_prover.TAIL_BITS)
    expected = {"gruen_round_scalar": 91 * head,
                "mimc_hash": 92 * min(bn, sumcheck_prover.TAIL_BITS) + head + 1}
    log(f"# expected from the round schedule: {json.dumps(expected)}; "
        f"{'as expected' if all(launches[k] == v for k, v in expected.items()) else 'DIFFERENT'}")
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

    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the grouped path: {missing}")
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
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"#   ptxas {line.split('ptxas info    :')[-1].strip()}")

    kernel_results = phase_kernels(bn, dev)  # 2.
    phase_golden(dev)  # 3.
    phase_cross_check(min(14, bn), dev)  # 4.
    phase_grouped_cross_check(min(12, bn - 2), 2, dev)
    launches = phase_main(bn, dev, card)  # 5.
    phase_grouped(bn - 2, GROUPS, dev, card)  # 6.

    kernels = []
    for name, (source, replaces) in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **kernel_results[name]})
    log(f"# chip_smoke total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
