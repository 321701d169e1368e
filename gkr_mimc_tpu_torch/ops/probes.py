"""Probes of the H100's cost model for the field arithmetic: one wrapper per
probe kernel, each beside its plain version, and an entry point that runs
the counterpart of each of the JAX package's micro-benchmark scripts on the
card:

    python -m gkr_mimc_tpu_torch.ops.probes micro_ops [--block 256] [--reps 256]
    python -m gkr_mimc_tpu_torch.ops.probes check_mxu_mul
    python -m gkr_mimc_tpu_torch.ops.probes micro_mul_split [--bn 20] [--threads 256] [--names mul,school]
    python -m gkr_mimc_tpu_torch.ops.probes micro_row_mul
    python -m gkr_mimc_tpu_torch.ops.probes micro_pe_mxu [--bn 20]

and two readings of the field core's chains that no script made:

    python -m gkr_mimc_tpu_torch.ops.probes latency   # ns a dependent step, one warp
    python -m gkr_mimc_tpu_torch.ops.probes sass      # the probes' loops by instruction

=================  =======================  =============================================
probe              CUDA source              replaces (def / pallas_call)
=================  =======================  =============================================
op_chain           csrc/probes.cu           scripts/micro_ops.py make_bench.kern :42 / :51
imma_dot           csrc/probes.cu           scripts/micro_ops.py dot_kern :97 / :109
field_check        csrc/probes.cu           scripts/check_mxu_mul.py kern :31 / :40
mul_chain          csrc/probes.cu           scripts/micro_mul_split.py make_chain_kernel
                                            :106 / :154
sbox_chain         csrc/probes.cu           scripts/micro_row_mul.py _chain_kernel_col
                                            :198, _chain_kernel_row :185 / :206
cipher_pe_variant  csrc/partial_evals.cu    scripts/micro_pe_mxu.py _cipher_pe_kernel2
                                            :47 / :94
=================  =======================  =============================================

The wrappers follow ``ops/kernels.py``: they check device, dtype, shape and
contiguity, launch on the current stream, raise on a non-zero
``cudaError_t``, count their launches (in ``PROBE_LAUNCHES``, apart from
``kernels.LAUNCHES``: the probes are not on the prover's path), and take
their plain version (``<name>_plain``, same output bits; the f32 body of
``op_chain`` to 1e-5 relative) only for CPU tensors. The entry point needs
a CUDA device and raises without one.

Rates are held to the H100 SXM data sheet at its 700 W limit: 132 SMs at
1.98 GHz, 64 32-bit integer results a clock per SM (multiply and the other
integer ops), 128 f32 FMAs, 1,979 T int8 tensor-core operations a second,
3.35 TB/s of device memory.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import re
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..fields import fr
from ..fields.bn254 import L, P, R1, RINV
from . import kernels as K

SMS = 132
CLOCK_HZ = 1.98e9
INT_RESULTS_PER_S = SMS * 64 * CLOCK_HZ  # 32-bit integer results
F32_FMA_PER_S = SMS * 128 * CLOCK_HZ
INT8_OPS_PER_S = 1979e12  # tensor cores, dense (a MAC is two operations)
HBM_BYTES_PER_S = 3.35e12
MULS_PER_PRODUCT = 264  # 32-bit multiply results of one CIOS Montgomery product
MIMC_SBOXES_PER_HASH = 9 * 91  # a 9-word transcript hash

_SRC = "gkr_mimc_tpu_torch/csrc/probes.cu"
# probe -> (CUDA source, the TPU kernel it replaces)
PROBES = {
    "op_chain": (_SRC, "scripts/micro_ops.py:51 (make_bench.kern :42)"),
    "imma_dot": (_SRC, "scripts/micro_ops.py:109 (dot_kern :97)"),
    "field_check": (_SRC, "scripts/check_mxu_mul.py:40 (kern :31)"),
    "mul_chain": (_SRC, "scripts/micro_mul_split.py:154 (make_chain_kernel :106)"),
    "sbox_chain": (_SRC, "scripts/micro_row_mul.py:206 (_chain_kernel_col :198, _chain_kernel_row :185)"),
    "cipher_pe_variant": ("gkr_mimc_tpu_torch/csrc/partial_evals.cu",
                          "scripts/micro_pe_mxu.py:94 (_cipher_pe_kernel2 :47)"),
}
PROBE_LAUNCHES = {name: 0 for name in PROBES}
MAX_ERR = {name: 0.0 for name in PROBES}  # largest difference from the plain version seen by check()

# op_chain bodies, in the order of csrc/probes.cu's Body: name -> (32-bit
# results a step, the data-sheet rate it is held to)
OP_BODIES = {
    "u32 mul": (1, INT_RESULTS_PER_S),
    "u32 add": (1, INT_RESULTS_PER_S),
    "u32 mul+add": (1, INT_RESULTS_PER_S),
    "u32 and+shr": (1, INT_RESULTS_PER_S),
    "u32 where": (1, INT_RESULTS_PER_S),
    "u32 roll": (1, INT_RESULTS_PER_S),
    "f32 fma": (1, F32_FMA_PER_S),
    "i32<->f32": (1, INT_RESULTS_PER_S),
    "u32 mul.hi": (1, INT_RESULTS_PER_S),
    "u32 mul.wide": (2, INT_RESULTS_PER_S),
    "u32 mad.cc": (2, INT_RESULTS_PER_S),
}
# mul_chain variants, in the order of csrc/probes.cu's Variant: name ->
# 32-bit multiply results a step (school: 64 widening products; redc: 8 m
# digits and 64 widening products; square: 28 cross and 8 diagonal widening
# products, then the same reduction; mul_fips: the hash chain's
# product-scanning product)
CHAIN_VARIANTS = {"mul": 264, "mul_ptx": 264, "square": 208, "school": 128, "redc": 136, "mul_fips": 264}
FIELD_VARIANTS = ("mul", "mul_ptx", "mul_fips")
LAYOUTS = ("col", "row")
# sbox_chain: dependent products an S-box, by layout, which are also the
# products a thread runs an S-box ("row" runs x^3 and x^4 on two threads)
SBOX_DEPTH = {"col": 4, "row": 3}
PE_THREADS = (128, 256, 512)
SBOX_ROUNDS = 91  # micro_row_mul.py: one permutation's worth of S-boxes
IMMA_MAX_REPS = 4095  # |sum| <= reps * 32 * 128 * 128 = reps * 2^19 < 2^31: the s32 sums stay exact
IMMA_THREADS = (128, 256)  # one or two warpgroups a block
IMMA_EQUAL_WORK = (4096, 8192, 8192)  # torch._int_mm (M, K) x (K, N): 2^38 MACs, the probe's at its default shape
LAZY_EDGES = [0, 1, 2, P - 2, P - 1, P, P + 1, 2 * P - 2, 2 * P - 1, (1 << 255) % P, 0xFFFFFFFF, 1 << 64]

_M16, _M32 = 0xFFFF, 0xFFFFFFFF


def reset_launch_counts() -> None:
    for name in PROBE_LAUNCHES:
        PROBE_LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plumbing
# ---------------------------------------------------------------------------


def check(name: str, got, want) -> float:
    """Hold a probe's output (or tuple of outputs) to its plain version's:
    bit for bit, a float32 output (op_chain's f32 body, fused on the card)
    to 1e-5 relative. Raises on a mismatch; returns the largest float
    difference (0.0 for bit-equal outputs) and keeps it in MAX_ERR."""
    gots = list(got) if isinstance(got, tuple) else [got]
    wants = list(want) if isinstance(want, tuple) else [want]
    err = 0.0
    for g, w in zip(gots, wants, strict=True):
        w = w.to(g.device)
        if g.dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
            err = max(err, float((g - w).abs().max().item()))
        elif not torch.equal(g, w):
            diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
            raise AssertionError(f"{name}: output differs from its plain version (largest difference {diff})")
    MAX_ERR[name] = max(MAX_ERR[name], err)
    return err


def _pick(name: str, value, choices):
    if value not in choices:
        raise ValueError(f"{name}: {value!r} is not one of {list(choices)}")
    return list(choices).index(value)


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> unsigned values in int64."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (any) -> int32 bit patterns of their low 32 bits."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul_lo(x, y):
    """lo32(x * y) of unsigned 32-bit values in int64 (no 64-bit overflow)."""
    return ((x & _M16) * y + ((((x >> 16) * y) & _M16) << 16)) & _M32


def _mul_hi(x, y):
    """hi32(x * y): x * y = 2^16 (x_hi y) + x_lo y, each below 2^48."""
    return ((x >> 16) * y + (((x & _M16) * y) >> 16)) >> 16


# ---------------------------------------------------------------------------
# op_chain: `reps` dependent 32-bit ops a thread
# ---------------------------------------------------------------------------


def op_chain(x: torch.Tensor, y: torch.Tensor, body: str, reps: int, threads: int = 256) -> torch.Tensor:
    """``reps`` dependent applications of ``body`` to each element, x <-
    body(x, y): x, y of one shape, n = x.numel() a multiple of 32, int32 bit
    patterns of uint32 (float32 for "f32 fma"). "u32 roll" takes the x of
    the element before, rotating each run of 32 consecutive elements."""
    b = _pick("op_chain", body, OP_BODIES)
    dtype = torch.float32 if body == "f32 fma" else torch.int32
    if x.shape != y.shape or x.numel() % 32 or x.numel() == 0:
        raise ValueError(f"op_chain: shapes {tuple(x.shape)}, {tuple(y.shape)}; need equal, numel % 32 == 0")
    if reps < 0:
        raise ValueError("op_chain: reps < 0")
    if K._on_cpu("op_chain", x, y, dtypes=(dtype,)):
        return op_chain_plain(x, y, body, reps, threads)
    out = torch.empty_like(x)
    K._launch("op_chain", "gkr_probe_op_chain", x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(),
              x.numel(), b, reps, threads, counts=PROBE_LAUNCHES)
    return out


def _op_step(body: str, x, y):
    if body == "u32 mul":
        return _mul_lo(x, y)
    if body == "u32 add":
        return (x + y) & _M32
    if body == "u32 mul+add":
        return (_mul_lo(x, y) + y) & _M32
    if body == "u32 and+shr":
        return ((x & y) + (x >> 16)) & _M32
    if body == "u32 where":
        return torch.maximum(x, y)
    if body == "u32 roll":
        return (x.reshape(-1, 32).roll(1, dims=1).reshape(x.shape) + y) & _M32
    if body == "f32 fma":
        return x * y + y
    if body == "i32<->f32":
        return (_u(_i32(x).to(torch.float32).to(torch.int32)) + y) & _M32
    if body == "u32 mul.hi":
        return (_mul_hi(x, y) + y) & _M32
    if body == "u32 mul.wide":
        return _mul_lo(x, y) ^ _mul_hi(x, y)
    if body == "u32 mad.cc":
        t = _mul_lo(x, y) + y  # mad.lo.cc: the carry out of this add
        return (_mul_hi(x, y) + (t & _M32) + (t >> 32)) & _M32
    raise KeyError(body)


def op_chain_plain(x, y, body, reps, threads=256):
    if body == "f32 fma":
        a = x.clone()
        for _ in range(reps):
            a = _op_step(body, a, y)
        return a
    a, b = _u(x), _u(y)
    for _ in range(reps):
        a = _op_step(body, a, b)
    return _i32(a)


# ---------------------------------------------------------------------------
# imma_dot: the integer tensor cores
# ---------------------------------------------------------------------------


def imma_dot(m: torch.Tensor, x: torch.Tensor, reps: int, threads: int = 128) -> torch.Tensor:
    """reps * (m @ x): m (64, 32) int8, x (32, n) int8 with n a multiple of
    8 -> (64, n) int32, by ``reps`` dependent wgmma accumulations on each
    64 x 256 tile; ``threads`` a block, 128 or 256 (one or two warpgroups).
    On the card m and x must be 16-byte aligned."""
    if m.shape != (64, 32) or x.dim() != 2 or x.shape[0] != 32 or x.shape[1] % 8 or x.shape[1] == 0:
        raise ValueError(f"imma_dot: shapes {tuple(m.shape)}, {tuple(x.shape)}; need (64, 32), (32, 8k)")
    if not 0 <= reps <= IMMA_MAX_REPS:
        raise ValueError(f"imma_dot: reps {reps} outside [0, {IMMA_MAX_REPS}]")
    if threads not in IMMA_THREADS:
        raise ValueError(f"imma_dot: threads {threads} is not one of {IMMA_THREADS}")
    if K._on_cpu("imma_dot", m, x, dtypes=(torch.int8,)):
        return imma_dot_plain(m, x, reps, threads)
    if m.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("imma_dot: m and x must be 16-byte aligned")
    out = torch.empty((64, x.shape[1]), dtype=torch.int32, device=x.device)
    K._launch("imma_dot", "gkr_probe_imma_dot", x.device, m.data_ptr(), x.data_ptr(), out.data_ptr(),
              x.shape[1], reps, threads, counts=PROBE_LAUNCHES)
    return out


def imma_dot_plain(m, x, reps, threads=128):
    """In float64, exact here: every sum is below 2^31 < 2^53."""
    return ((m.to(torch.float64) @ x.to(torch.float64)) * reps).to(torch.int32)


# ---------------------------------------------------------------------------
# field_check: mul, square and x^7 of one multiply
# ---------------------------------------------------------------------------


def field_check(a: torch.Tensor, b: torch.Tensor, variant: str):
    """(a * b, a^2, a^7) in Montgomery form on lazy representatives: a, b
    (8, n) -> three (8, n). The product and x^7 (square, mul, square, mul)
    run on ``variant``'s multiply (fr::mul, fr::mul_ptx or fr::mul_fips),
    the square on fr::square (fr::square_fips beside fr::mul_fips)."""
    v = _pick("field_check", variant, FIELD_VARIANTS)
    n = K._table_n("field_check", a)
    if b.shape != a.shape:
        raise ValueError(f"field_check: shapes {tuple(a.shape)}, {tuple(b.shape)}")
    if K._on_cpu("field_check", a, b):
        return field_check_plain(a, b, variant)
    outs = [torch.empty_like(a) for _ in range(3)]
    K._launch("field_check", "gkr_probe_field_check", a.device, a.data_ptr(), b.data_ptr(),
              *(o.data_ptr() for o in outs), n, v, counts=PROBE_LAUNCHES)
    return tuple(outs)


def field_check_plain(a, b, variant):
    return fr.mul(a, b), fr.square(a), fr.pow7(a)


# ---------------------------------------------------------------------------
# mul_chain: `chain` dependent field ops a thread
# ---------------------------------------------------------------------------


def mul_chain(a: torch.Tensor, b: torch.Tensor, variant: str, chain: int = 8, threads: int = 256) -> torch.Tensor:
    """``chain`` dependent steps x <- f(x, b) from x = a, (8, n) tables:
    "mul" fr::mul(x, b), "mul_ptx" fr::mul_ptx(x, b), "mul_fips"
    fr::mul_fips(x, b), "square" fr::square(x) (all REDC of a product, on
    lazy representatives), "school" the 512-bit
    product x * b folded as lo256 ^ hi256, "redc" the REDC of the 512-bit
    value x + b * 2^256 (any 256-bit x, b < 2p)."""
    v = _pick("mul_chain", variant, CHAIN_VARIANTS)
    n = K._table_n("mul_chain", a)
    if b.shape != a.shape:
        raise ValueError(f"mul_chain: shapes {tuple(a.shape)}, {tuple(b.shape)}")
    if chain < 0:
        raise ValueError("mul_chain: chain < 0")
    if K._on_cpu("mul_chain", a, b):
        return mul_chain_plain(a, b, variant, chain, threads)
    out = torch.empty_like(a)
    K._launch("mul_chain", "gkr_probe_mul_chain", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
              n, v, chain, threads, counts=PROBE_LAUNCHES)
    return out


def _fold_product(x, y):
    """lo256 ^ hi256 of the 512-bit product x * y."""
    cols = fr.product_columns(x, y)
    for i in range(31):
        cols[i + 1] += cols[i] >> 16
        cols[i] &= _M16
    words = cols[0:32:2] | (cols[1:32:2] << 16)  # (16, *S) 32-bit words
    return _i32(words[:L] ^ words[L:])


def _redc_high(x, y):
    """REDC(x + y * 2^256)."""
    digits = torch.cat([fr._split16(x), fr._split16(y)])
    cols = torch.cat([digits, torch.zeros_like(digits[:1])])  # 33 columns
    return fr.redc_columns(cols)


def mul_chain_plain(a, b, variant, chain=8, threads=256):
    step = {
        "mul": fr.mul,
        "mul_ptx": fr.mul,
        "square": lambda x, _: fr.square(x),
        "school": _fold_product,
        "redc": _redc_high,
        "mul_fips": fr.mul,
    }[variant]
    x = a
    for _ in range(chain):
        x = step(x, b)
    return x


# ---------------------------------------------------------------------------
# sbox_chain: the latency of dependent S-boxes on one element
# ---------------------------------------------------------------------------


def sbox_chain(x: torch.Tensor, layout: str, rounds: int = SBOX_ROUNDS) -> torch.Tensor:
    """``rounds`` dependent x^7 on each element of an (8, n) table ->
    (8, n) canonical: "col" one thread an element, four products deep,
    "row" a pair of threads of one warp an element, three deep (x^3 and x^4
    side by side); both on the product in radix 2^52 on the FP64 units."""
    lay = _pick("sbox_chain", layout, LAYOUTS)
    n = K._table_n("sbox_chain", x)
    if rounds < 0:
        raise ValueError("sbox_chain: rounds < 0")
    if K._on_cpu("sbox_chain", x):
        return sbox_chain_plain(x, layout, rounds)
    out = torch.empty_like(x)
    K._launch("sbox_chain", "gkr_probe_sbox_chain", x.device, x.data_ptr(), out.data_ptr(), n, lay, rounds,
              counts=PROBE_LAUNCHES)
    return out


def sbox_chain_plain(x, layout, rounds=SBOX_ROUNDS):
    """The chain on host ints: the element's value v = x R^-1 mod p goes
    to v^(7^rounds), returned in canonical Montgomery form."""
    vals = [v * RINV % P for v in fr.limb_values(x)]
    e = pow(7, rounds)
    return fr.encode_mont_ints([pow(v, e, P) for v in vals], x.device)


# ---------------------------------------------------------------------------
# cipher_pe_variant: the partial-evals kernel on fr::mul_ptx
# ---------------------------------------------------------------------------


def cipher_pe_variant(eq: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, ark: torch.Tensor,
                      threads: int = 256) -> torch.Tensor:
    """The cipher round's sums at t = 0..8 (one group) by the per-t design,
    the S-box at every t (``kernels.cipher_evals_per_t``, lazy), on the
    kernel instantiated with fr::mul_ptx at ``threads`` = 128, 256 or 512
    a block: eq, x0, x1 (8, n), ark (8, 1) -> (8, 9, 1). The production
    kernel (``kernels.cipher_partial_evals``) computes the same values,
    canonical, by the deferred contraction."""
    _pick("cipher_pe_variant", threads, PE_THREADS)
    K._expect("cipher_pe_variant", ark, (L, 1))
    half = K._round_geometry("cipher_pe_variant", [eq, x0, x1], 1)
    if K._on_cpu("cipher_pe_variant", eq, x0, x1, ark):
        return cipher_pe_variant_plain(eq, x0, x1, ark, threads)
    bpg = max(1, min(-(-half // threads), 2048 * 256 // threads))  # 2048 blocks of 256 threads in flight
    partial = torch.empty((bpg, K.CIPHER_EVALS, L), dtype=torch.int32, device=eq.device)
    out = torch.empty((L, K.CIPHER_EVALS, 1), dtype=torch.int32, device=eq.device)
    K._launch("cipher_pe_variant", "gkr_cipher_partial_evals_ptx", eq.device, eq.data_ptr(), x0.data_ptr(),
              x1.data_ptr(), ark.data_ptr(), partial.data_ptr(), out.data_ptr(), half, 1, bpg, threads,
              counts=PROBE_LAUNCHES)
    return out


def cipher_pe_variant_plain(eq, x0, x1, ark, threads=256):
    return K.cipher_evals_per_t(eq, x0, x1, ark, 1, K.CIPHER_EVALS, False)


PLAIN = {
    "op_chain": op_chain_plain,
    "imma_dot": imma_dot_plain,
    "field_check": field_check_plain,
    "mul_chain": mul_chain_plain,
    "sbox_chain": sbox_chain_plain,
    "cipher_pe_variant": cipher_pe_variant_plain,
}


# ---------------------------------------------------------------------------
# Inputs (numpy seeds, as the scripts draw theirs)
# ---------------------------------------------------------------------------


def lazy_table(n: int, seed: int, device) -> torch.Tensor:
    """(8, n) lazy representatives (< 2p) from a numpy seed."""
    limbs = np.random.default_rng(seed).integers(0, 1 << 32, size=(L, n), dtype=np.uint64)
    limbs[L - 1] %= (2 * P) >> (32 * (L - 1))  # top limb below 2p's: the value is below 2p
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)


def op_inputs(shape, body: str, device, bits: int = 16, seed: int = 0):
    """micro_ops.py's inputs: x in [0, 2^bits), y in [1, 2^bits) (uint32;
    bits = 16 as the script draws them), or x, y in [0, 1) (float32,
    "f32 fma"), from a numpy seed. "i32<->f32" keeps bits = 16: its round
    trip through f32 is defined below 2^31 - 2^7."""
    rng = np.random.default_rng(seed)
    if body == "f32 fma":
        x, y = rng.random(size=shape, dtype=np.float32), rng.random(size=shape, dtype=np.float32)
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    top = 1 << (16 if body == "i32<->f32" else bits)
    x = rng.integers(0, top, size=shape, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(1, top, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device), torch.from_numpy(y.view(np.int32)).to(device)


def imma_inputs(n: int, device):
    """M (64, 32) and x (32, n) with pieces in [0, 128) (valid s8), seed 0."""
    rng = np.random.default_rng(0)
    m = rng.integers(0, 128, size=(64, 32), dtype=np.int8)
    x = rng.integers(0, 128, size=(32, n), dtype=np.int8)
    return torch.from_numpy(m).to(device), torch.from_numpy(x).to(device)


def field_check_ints():
    """check_mxu_mul.py's 256 lazy representatives and its edge cases."""
    rng = np.random.default_rng(42)
    av = [rng.integers(0, 1 << 62).item() * rng.integers(0, 1 << 62).item() % (2 * P) for _ in range(256)]
    bv = [rng.integers(0, 1 << 62).item() * rng.integers(0, 1 << 62).item() % (2 * P) for _ in range(256)]
    av[:4] = [0, 1, P - 1, 2 * P - 1]
    bv[:4] = [2 * P - 1, P, 1, 2 * P - 1]
    return av, bv


def small_cases(dev) -> dict:
    """Per probe: argument tuples at a few hundred elements (reps = 8), on
    which each probe kernel is held to its plain version."""
    av, bv = field_check_ints()
    a, b = fr._limb_tensor(av, dev), fr._limb_tensor(bv, dev)
    m, x = imma_inputs(64, dev)
    mw, xw = imma_inputs(1032, dev)  # five tiles, the last 8 columns wide
    chain_x = fr._limb_tensor(LAZY_EDGES + fr.limb_values(lazy_table(288, 5, "cpu")), dev)
    pe = [lazy_table(1 << 12, s, dev) for s in (1, 2, 3)]
    ark = fr.encode_mont_ints([145646], dev)
    return {
        "op_chain": [op_inputs((16, 32), body, dev, bits=bits, seed=bits) + (body, 8)
                     for body in OP_BODIES for bits in (16, 32)],
        "imma_dot": [(m, x, 8), (m, x[:, :8].contiguous(), 3)] + [(mw, xw, 5, t) for t in IMMA_THREADS],
        "field_check": [(a, b, v) for v in FIELD_VARIANTS],
        "mul_chain": [(chain_x, chain_x.flip(1).contiguous(), v, 8) for v in CHAIN_VARIANTS],
        "sbox_chain": [(fr._limb_tensor(LAZY_EDGES[:5], dev), layout) for layout in LAYOUTS],
        "cipher_pe_variant": [(*pe, ark, t) for t in PE_THREADS],
    }


def field_check_values(av, bv, outs) -> int:
    """check_mxu_mul.py's check of the three outputs: each below 2p and
    congruent to a b R^-1, a^2 R^-1 and x^7 R with x = a R^-1 (mod p).
    Returns the number of mismatches."""
    got_mul, got_sq, got_pow7 = (fr.limb_values(o) for o in outs)
    bad = 0
    for i, (a, b) in enumerate(zip(av, bv)):
        x = a * RINV % P
        wants = (a * b * RINV % P, a * a * RINV % P, pow(x, 7, P) * R1 % P)
        for got, want in zip((got_mul[i], got_sq[i], got_pow7[i]), wants):
            bad += got >= 2 * P or got % P != want
    return bad


# ---------------------------------------------------------------------------
# The entry point: each script's counterpart on the card
# ---------------------------------------------------------------------------


def time_ms(fn, *args) -> float:
    """ms a call, CUDA events: one warm-up call, one timed call, and when
    that took under 20 ms, enough calls back to back to fill 20 ms."""
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if ms >= 20.0:
        return ms
    reps = math.ceil(20.0 / max(ms, 1e-3))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device; none is available")
    return torch.device("cuda", 0)


def run_micro_ops(block: int = 256, reps: int = 256, n: int = 1 << 19) -> dict:
    """micro_ops.py: every op_chain body over a (16, n) table and the
    tensor-core dot at (64, 32) x (32, n); ms, T lane-ops/s and the share
    of the data-sheet rate. Each timed case is first held to its plain
    version. Returns {case: (ms, args)}; "int_mm" is the PyTorch call
    torch._int_mm(m, x) * reps, the same function as imma_dot."""
    dev = _device()
    out = {}
    for body, (results, rate) in OP_BODIES.items():
        x, y = op_inputs((16, n), body, dev)
        args = (x, y, body, reps, block)
        check("op_chain", op_chain(*args), op_chain_plain(*args))
        ms = time_ms(op_chain, *args)
        lane_ops = reps * x.numel() / (ms * 1e-3)
        print(f"{body:12s}: {ms:7.4f} ms -> {lane_ops / 1e12:7.3f} T lane-ops/s, {results * lane_ops / 1e12:7.3f} "
              f"T results/s ({results * lane_ops / rate:6.1%} of {rate / 1e12:.2f} T/s)", flush=True)
        out[body] = (ms, args)
    m, x = imma_inputs(n, dev)
    args = (m, x, reps, 128)
    got = imma_dot(*args)
    check("imma_dot", got, imma_dot_plain(*args))
    for mv, xv in ((-128, -128), (127, 127), (-128, 127)):  # the s32 sums' extremes
        ext = (torch.full_like(m, mv), torch.full_like(x, xv), IMMA_MAX_REPS, 128)
        check("imma_dot", imma_dot(*ext), imma_dot_plain(*ext))
    print(f"imma_dot at reps {IMMA_MAX_REPS} on all-(-128), all-127 and mixed inputs: equal to its plain version",
          flush=True)
    ms = time_ms(imma_dot, *args)
    macs = reps * 64 * 32 * n
    if not torch.equal(int_mm_scaled(m, x, reps), got):
        raise AssertionError("torch._int_mm(m, x) * reps differs from imma_dot")
    lib_ms = time_ms(int_mm_scaled, m, x, reps)
    a, b = int_mm_equal_inputs(dev)
    eq_macs = a.shape[0] * a.shape[1] * b.shape[1]
    eq_ms = time_ms(torch._int_mm, a, b)
    rate = lambda k, t: k / (t * 1e-3) / 1e12  # noqa: E731
    print(f"{'s8 wgmma 64x32':12s}: {ms:7.4f} ms -> {rate(macs, ms):7.3f} T MAC/s "
          f"({2 * macs / (ms * 1e-3) / INT8_OPS_PER_S:6.1%} of {INT8_OPS_PER_S / 2e12:.1f} T MAC/s); "
          f"torch._int_mm(m, x) * {reps}: {lib_ms:.4f} ms ({rate(64 * 32 * n, lib_ms):7.3f} T MAC/s of its own, "
          f"one product: 1/{reps} of the MACs, a value check and no yardstick); torch._int_mm at equal work "
          f"{a.shape[0]}x{a.shape[1]} @ {a.shape[1]}x{b.shape[1]} ({eq_macs} MACs): {eq_ms:.4f} ms "
          f"({rate(eq_macs, eq_ms):7.3f} T MAC/s, {2 * eq_macs / (eq_ms * 1e-3) / INT8_OPS_PER_S:6.1%}); "
          f"the kernel at {rate(macs, ms) / rate(eq_macs, eq_ms):.3f}x cuBLAS's rate", flush=True)
    out["imma_dot"] = (ms, args)
    out["int_mm"] = (lib_ms, (m, x, reps))
    out["int_mm_equal"] = (eq_ms, (a, b))
    return out


def int_mm_equal_inputs(dev):
    """torch._int_mm's operands at imma_dot's work (IMMA_EQUAL_WORK, 2^38
    MACs at the default shape), random s8 from a seeded generator, B
    column-major (cuBLAS's int8 layout); the product is first held to a
    float64 one on a slice (exact: every sum is below 2^53)."""
    rows, depth, cols = IMMA_EQUAL_WORK
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-128, 128, (rows, depth), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-128, 128, (cols, depth), dtype=torch.int8, device=dev, generator=g).t()
    got = torch._int_mm(a, b)[:16, :64].to(torch.float64)
    if not torch.equal(got, a[:16].to(torch.float64) @ b[:, :64].to(torch.float64)):
        raise AssertionError("torch._int_mm at equal work differs from its float64 product on a slice")
    return a, b


def int_mm_scaled(m, x, reps):
    """imma_dot's function as PyTorch computes it: one s8 product, scaled."""
    return torch._int_mm(m, x) * reps


def run_check_mxu_mul() -> dict:
    """check_mxu_mul.py: field_check of both multiplies on the script's 256
    inputs; raises on a mismatch. Returns {variant: (ms, args)}."""
    dev = _device()
    av, bv = field_check_ints()
    a, b = fr._limb_tensor(av, dev), fr._limb_tensor(bv, dev)
    out = {}
    for variant in FIELD_VARIANTS:
        outs = field_check(a, b, variant)
        bad = field_check_values(av, bv, outs)
        print(f"field_check {variant}: {'OK' if bad == 0 else f'FAILED: {bad} mismatches'}", flush=True)
        if bad:
            raise AssertionError(f"field_check {variant}: {bad} mismatches")
        check("field_check", outs, field_check_plain(a, b, variant))
        out[variant] = (time_ms(field_check, a, b, variant), (a, b, variant))
    return out


def run_micro_mul_split(bn: int = 20, threads: int = 256, names=CHAIN_VARIANTS, chain: int = 8) -> dict:
    """micro_mul_split.py: `chain` dependent ops on 2^bn elements for each
    variant; ns a product an element and the share of the 264-result
    bound. Each timed case is first held to its plain version. Returns
    {variant: (ms, args)}."""
    dev = _device()
    n = 1 << bn
    a, b = lazy_table(n, 1, dev), lazy_table(n, 2, dev)
    small = 1 << 10
    v1 = mul_chain(a[:, :small].contiguous(), b[:, :small].contiguous(), "mul", chain, threads)
    v2 = mul_chain(a[:, :small].contiguous(), b[:, :small].contiguous(), "mul_ptx", chain, threads)
    ok = torch.equal(v1, v2)
    print(f"mul_ptx == mul: {ok}", flush=True)
    if not ok:
        raise AssertionError("mul_chain: mul_ptx and mul differ")
    bound_ns = MULS_PER_PRODUCT / INT_RESULTS_PER_S * 1e9
    out = {}
    for name in names:
        args = (a, b, name, chain, threads)
        check("mul_chain", mul_chain(*args), mul_chain_plain(*args))
        ms = time_ms(mul_chain, *args)
        ns = ms * 1e6 / chain / n
        own_ns = CHAIN_VARIANTS[name] / INT_RESULTS_PER_S * 1e9
        print(f"{name:8s} chain{chain} n=2^{bn} threads={threads}: {ms:7.4f} ms -> {ns:7.4f} ns/mul/elem "
              f"({bound_ns / ns:6.1%} of the {MULS_PER_PRODUCT}-result product's bound, {bound_ns:.4f} ns; "
              f"{own_ns / ns:6.1%} of its own {CHAIN_VARIANTS[name]} results' bound)", flush=True)
        out[name] = (ms, args)
    return out


def run_micro_row_mul(rounds: int = SBOX_ROUNDS) -> dict:
    """micro_row_mul.py: `rounds` dependent x^7 on one element in both
    layouts, each first held to the plain version at the lazy edges and on
    the timed element, at `rounds` and 2 `rounds`, then "row == col
    chain"; for each layout: µs an S-box, ns a dependent product (from the
    slope between `rounds` and 2 `rounds`, which leaves out the launch),
    its loop's SASS instructions (``sass``) and its ratio to the transcript
    hash's chain (K.mimc_hash, 9 words, csrc/mimc.cuh). Returns {layout:
    (ms, args)}, {("numbers", layout): {...}} and "mimc_hash"."""
    dev = _device()
    x = lazy_table(1, 3, dev)
    edges = fr._limb_tensor(LAZY_EDGES, dev)
    for layout in LAYOUTS:
        for r in (rounds, 2 * rounds):
            for t in (edges, x):
                check("sbox_chain", sbox_chain(t, layout, r), sbox_chain_plain(t, layout, r))
    print(f"sbox_chain: both layouts equal to the plain version at the {len(LAZY_EDGES)} lazy edges and the timed "
          f"element, at {rounds} and {2 * rounds} rounds", flush=True)
    same = torch.equal(sbox_chain(x, "row", rounds), sbox_chain(x, "col", rounds))
    print(f"row == col chain: {same}", flush=True)
    if not same:
        raise AssertionError("sbox_chain: the layouts differ")
    msgs = lazy_table(9, 4, dev)
    hash_ms = time_ms(K.mimc_hash, msgs)
    hash_us = hash_ms * 1e3 / MIMC_SBOXES_PER_HASH
    print(f"mimc_hash (9 words, {MIMC_SBOXES_PER_HASH} sboxes): {hash_ms * 1e3:8.1f} us ({hash_us:7.4f} us/sbox, "
          f"{hash_us * 1e3 / 3:7.1f} ns a dependent product, 3 deep)", flush=True)
    loops = sass_loops_of_library()
    out = {"mimc_hash": (hash_ms, (msgs,))}
    for layout in LAYOUTS:
        ms = time_ms(sbox_chain, x, layout, rounds)
        slope_us = (time_ms(sbox_chain, x, layout, 2 * rounds) - ms) * 1e3 / rounds
        loop = [loop for name, (loop, _) in loops.items() if f"sbox_{layout}_kernel" in name]
        row = {"layout": layout, "depth": SBOX_DEPTH[layout], "us_a_sbox": ms * 1e3 / rounds,
               "slope_us_a_sbox": slope_us, "ns_a_dependent_product": slope_us * 1e3 / SBOX_DEPTH[layout],
               "cycles_a_dependent_product": slope_us * 1e-6 / SBOX_DEPTH[layout] * CLOCK_HZ,
               "loop_sass": len(loop[0]) if len(loop) == 1 else None,
               "sass_a_product": len(loop[0]) / SBOX_DEPTH[layout] if len(loop) == 1 else None,
               "x_mimc_hash_sbox": slope_us / hash_us}
        print(json.dumps({"sbox_chain": row}), flush=True)
        out[layout] = (ms, (x, layout, rounds))
        out[("numbers", layout)] = row
    return out


def run_micro_pe_mxu(bn: int = 20) -> dict:
    """micro_pe_mxu.py: the cipher partial evals (9 evals) on fr::mul_ptx
    against the production kernel (v1), as the TPU script compares its
    variant with the production kernel: value match at 2^12, then ms at
    2^bn for each block size and the speed-up, each timed case first held
    to v1's output there and v1's to the plain version. The variant keeps
    the per-t design (5 products a t) and v1 is the deferred contraction,
    so the speed-up compares two designs as well as two multiplies; the
    variant's lazy sums are compared canonical. Returns {case: (ms, args)}."""
    dev = _device()
    n = 1 << bn
    eq, x0, x1 = (lazy_table(n, s, dev) for s in (1, 2, 3))
    ark = fr.encode_mont_ints([145646], dev)
    small = 1 << 12
    sl = [t[:, :small].contiguous() for t in (eq, x0, x1)]
    v1 = K.cipher_partial_evals(*sl, ark, 1, K.CIPHER_EVALS, False)
    ok = all(torch.equal(v1, fr.canonicalize(cipher_pe_variant(*sl, ark, t))) for t in PE_THREADS)
    print(f"value match v1 vs mul_ptx: {ok}", flush=True)
    if not ok:
        raise AssertionError("cipher_pe_variant differs from cipher_partial_evals")
    v1 = K.cipher_partial_evals(eq, x0, x1, ark, 1, K.CIPHER_EVALS, False)
    check("cipher_pe_variant", v1, fr.canonicalize(cipher_pe_variant_plain(eq, x0, x1, ark)))
    t1 = time_ms(K.cipher_partial_evals, eq, x0, x1, ark, 1, K.CIPHER_EVALS, False)
    print(f"pe v1 (deferred contraction) n=2^{bn}: {t1:8.4f} ms", flush=True)
    out = {"v1": (t1, (eq, x0, x1, ark, 1, K.CIPHER_EVALS, False))}
    for t in PE_THREADS:
        args = (eq, x0, x1, ark, t)
        check("cipher_pe_variant", fr.canonicalize(cipher_pe_variant(*args)), v1)
        t2 = time_ms(cipher_pe_variant, *args)
        print(f"pe mul_ptx ({t:3d} threads) n=2^{bn}: {t2:8.4f} ms   ({t1 / t2:.3f}x)", flush=True)
        out[t] = (t2, args)
    return out


def run_latency(reps: int = 1 << 14, chain: int = 256) -> dict:
    """ns a dependent step on one warp of an otherwise idle card: the slope
    of op_chain on 32 elements between ``reps`` and 2 ``reps`` steps for the
    bodies the field core is built from, and of mul_chain on one element
    between ``chain`` and 2 ``chain`` steps. Cycles are at CLOCK_HZ.
    Returns {case: ns}."""
    dev = _device()
    out = {}

    def report(case: str, ns: float) -> None:
        print(f"{case:18s}: {ns:8.3f} ns a dependent step ({ns * 1e-9 * CLOCK_HZ:7.1f} cycles at "
              f"{CLOCK_HZ / 1e9:.2f} GHz)", flush=True)
        out[case] = ns

    for body in ("u32 mul", "u32 mul.wide", "u32 mad.cc", "u32 add", "u32 and+shr", "u32 roll"):
        x, y = op_inputs((1, 32), body, dev)
        t1, t2 = (time_ms(op_chain, x, y, body, r, 32) for r in (reps, 2 * reps))
        report(f"op_chain {body}", (t2 - t1) * 1e6 / reps)
    a, b = lazy_table(1, 1, dev), lazy_table(1, 2, dev)
    for variant in CHAIN_VARIANTS:
        t1, t2 = (time_ms(mul_chain, a, b, variant, c, 32) for c in (chain, 2 * chain))
        report(f"mul_chain {variant}", (t2 - t1) * 1e6 / chain)
    return out


# kernel (a part of its mangled name) -> (label, steps in its largest loop)
SASS_KERNELS = {
    **{f"op_chain_kernelILi{i}E": (f"op_chain {body}", 16) for i, body in enumerate(OP_BODIES)},
    **{f"mul_chain_kernelILi{i}E": (f"mul_chain {v}", 1) for i, v in enumerate(CHAIN_VARIANTS)},
    **{f"sbox_{layout}_kernel": (f"sbox_chain {layout} (products)", SBOX_DEPTH[layout]) for layout in LAYOUTS},
}
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def sass_loops(text: str) -> dict:
    """cuobjdump -sass text -> {function: (instructions of its largest
    loop as [opcode], all its instructions as [opcode])}. A loop is the
    span from a backward branch's target to the branch."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, labels, pending = m.group(1), {}, []
            funcs[name] = []
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.search(line)
        if m and name:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            funcs[name].append((addr, m.group(2), m.group(3), labels))
    out = {}
    for name, insns in funcs.items():
        addrs, ops = [a for a, _, _, _ in insns], [o for _, o, _, _ in insns]  # in address order
        best = []
        for i, (addr, op, operands, labels) in enumerate(insns):
            t = _SASS_TARGET.search(operands) if op.startswith("BRA") else None
            if t is None:
                continue
            target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
            if target is not None and target <= addr:
                body = ops[bisect.bisect_left(addrs, target):i + 1]
                best = body if len(body) > len(best) else best
        out[name] = (best, ops)
    return out


@lru_cache(maxsize=1)
def sass_loops_of_library() -> dict:
    """``sass_loops`` of the built kernel library (``cuobjdump -sass``),
    read once a process."""
    from . import build

    lib = build.build()
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    return sass_loops(text)


def run_sass() -> dict:
    """The probes' chains as ptxas compiled them (``cuobjdump -sass`` of
    the built library): for each chain kernel, the instructions of its
    largest loop by opcode and a step's share of them (an op_chain loop
    holds 16 steps, a mul_chain loop one, an sbox_chain loop one x^7: 4
    products on a "col" thread, 3 on a "row" thread). Returns
    {label: {opcode: count in the loop}}."""
    loops = sass_loops_of_library()
    out = {}
    for key, (label, steps) in SASS_KERNELS.items():
        names = [n for n in loops if key in n]
        if len(names) != 1:
            raise RuntimeError(f"sass: {len(names)} functions match {key}")
        loop, whole = loops[names[0]]
        hist = dict(sorted(((op, loop.count(op)) for op in set(loop)), key=lambda kv: -kv[1]))
        print(json.dumps({"kernel": label, "loop_instructions": len(loop), "steps_a_loop": steps,
                          "a_step": round(len(loop) / steps, 2), "kernel_instructions": len(whole),
                          "loop_by_opcode": hist}), flush=True)
        out[label] = hist
    return out


SCRIPTS = {
    "micro_ops": lambda a: run_micro_ops(a.block, a.reps),
    "check_mxu_mul": lambda a: run_check_mxu_mul(),
    "micro_mul_split": lambda a: run_micro_mul_split(a.bn, a.threads, a.names.split(",")),
    "micro_row_mul": lambda a: run_micro_row_mul(),
    "micro_pe_mxu": lambda a: run_micro_pe_mxu(a.bn),
    "latency": lambda a: run_latency(),
    "sass": lambda a: run_sass(),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the H100 counterpart of one of the TPU micro-benchmark scripts, "
                                             "or read the field core's chains (latency, sass).")
    ap.add_argument("script", choices=sorted(SCRIPTS))
    ap.add_argument("--block", type=int, default=256, help="threads a block of op_chain (micro_ops.py's MB)")
    ap.add_argument("--reps", type=int, default=256, help="dependent reps of op_chain and imma_dot (MR)")
    ap.add_argument("--bn", type=int, default=20, help="log2 elements of mul_chain and the partial evals (MBN)")
    ap.add_argument("--threads", type=int, default=256, help="threads a block of mul_chain (MBLOCK)")
    ap.add_argument("--names", default=",".join(CHAIN_VARIANTS), help="mul_chain variants (MNAMES)")
    args = ap.parse_args(argv)
    _device()
    print(f"# {torch.cuda.get_device_name(0)}; {args.script}", flush=True)
    SCRIPTS[args.script](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
