"""The port's CUDA kernels: one wrapper per kernel, each beside its plain
torch twin.

Every Pallas kernel of the reference's ``ops/kernels.py`` (those that its
sumcheck paths, its witness and its circuits' gates reach) has a
hand-written CUDA counterpart in ``csrc/`` (compiled for sm_90a by
``ops/build.py``):

======================  ======================  ===============================================
wrapper                 CUDA source             replaces (gkr_mimc_tpu/ops/kernels.py)
======================  ======================  ===============================================
mimc_witness            csrc/witness.cu         mimc_witness (:136)
mimc_hash               csrc/mimc_hash.cu       mimc_hash_fs (:253), G = 1
mimc_hash_g             csrc/mimc_hash.cu       mimc_hash_fs_g (:1321), G lanes
fold                    csrc/elementwise.cu     fold_tables_band (:935), fold_tables_gm (:867),
                                                fold_tables (:1519), fold_tables_g (:1240)
suffix_step             csrc/elementwise.cu     suffix_step_band (:1000)
multi_eq                csrc/elementwise.cu     multi_eq_accum (:1588)
mul_scalar              csrc/elementwise.cu     mul_scalar (:1616)
gruen_acc               csrc/round_acc.cu       cipher_gruen_acc (:740) + finish_gruen_acc
cipher_coeff_acc        csrc/round_acc.cu       cipher_coeff_acc (:644) + finish_coeff_acc
identity_acc            csrc/round_acc.cu       identity_coeff_acc (:651) + finish_coeff_acc
cipher_partial_evals    csrc/round_acc.cu       cipher_partial_evals (:377), cipher_partial_evals_g (:1211)
identity_partial_evals  csrc/partial_evals.cu   identity_partial_evals (:411), identity_partial_evals_g (:1223)
gruen_round_scalar      csrc/gruen_round.cu     gruen_round_scalar (:1446)
pow7                    csrc/sbox.cu            pow7 (:71)
cipher_layer            csrc/sbox.cu            cipher_layer (:89)
tail_rounds             csrc/tail.cu            the tail program gkr_mimc_tpu/sumcheck/prover.py
                                                _tail_body (:559), with cipher_layer (:89) and
                                                mimc_hash_fs (:253) inside it
======================  ======================  ===============================================

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current CUDA stream, raises if the C entry returns a non-zero
``cudaError_t``, and adds one to ``LAUNCHES[name]``. It takes its plain twin
(``<name>_plain``, same signature, same output bits) only for tensors on
the CPU. Callers reach the wrappers through this module's attributes
(``K.fold(...)``), so a caller's check can swap in the plain twins.

Tables are group-major: an (8, G*n) table holds G groups of n entries, and
a per-group scalar is an (8, G) tensor.

The three cipher rounds (``gruen_acc``, ``cipher_coeff_acc``,
``cipher_partial_evals``) share one pass 1 in ``csrc/round_acc.cu``: the
reduction deferred past the sum over the points, the sum a byte-digit
contraction on the tensor cores; they return canonical values.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from ..fields import fr
from ..fields.bn254 import L
from ..hashes.ark import arks_mont
from ..poly import lagrange
from . import build

MIMC_ROUNDS = 91
_ACC_THREADS = 256  # threads per block of the identity rounds (csrc/reduce.cuh rsum::kThreads)
# the cipher rounds' deferred contraction (csrc/round_acc.cu, namespace deferred)
DEFERRED_TILE = 256  # points a tile of pass 1 (deferred::kTile)
DEFERRED_WINDOWS = 35  # byte windows of a weight with a nonzero byte (deferred::kLiveWins)
DEFERRED_COLS = 100  # byte columns a sum in the partials (deferred::kCols)
DEFERRED_FLUSH_POINTS = 32 * DEFERRED_TILE  # s32 digit sums flushed this often (deferred::kFlushTiles tiles)
DEFERRED_WIDE_WORDS = 26  # 32-bit words of a sum's exact integer in pass 2 (deferred::kWideWords)

# wrapper -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "mimc_witness": ("gkr_mimc_tpu_torch/csrc/witness.cu", "gkr_mimc_tpu/ops/kernels.py:136"),
    "mimc_hash": ("gkr_mimc_tpu_torch/csrc/mimc_hash.cu", "gkr_mimc_tpu/ops/kernels.py:253"),
    "mimc_hash_g": ("gkr_mimc_tpu_torch/csrc/mimc_hash.cu", "gkr_mimc_tpu/ops/kernels.py:1321"),
    "fold": ("gkr_mimc_tpu_torch/csrc/elementwise.cu",
             "gkr_mimc_tpu/ops/kernels.py:935 fold_tables_band, :867 fold_tables_gm, "
             ":1519 fold_tables, :1240 fold_tables_g"),
    "suffix_step": ("gkr_mimc_tpu_torch/csrc/elementwise.cu", "gkr_mimc_tpu/ops/kernels.py:1000"),
    "multi_eq": ("gkr_mimc_tpu_torch/csrc/elementwise.cu", "gkr_mimc_tpu/ops/kernels.py:1588"),
    "mul_scalar": ("gkr_mimc_tpu_torch/csrc/elementwise.cu", "gkr_mimc_tpu/ops/kernels.py:1616"),
    "gruen_acc": ("gkr_mimc_tpu_torch/csrc/round_acc.cu",
                  "gkr_mimc_tpu/ops/kernels.py:740 cipher_gruen_acc (call :777), :813 finish_gruen_acc"),
    "cipher_coeff_acc": ("gkr_mimc_tpu_torch/csrc/round_acc.cu",
                         "gkr_mimc_tpu/ops/kernels.py:644 cipher_coeff_acc (call :630), :1057 finish_coeff_acc"),
    "identity_acc": ("gkr_mimc_tpu_torch/csrc/round_acc.cu", "gkr_mimc_tpu/ops/kernels.py:651"),
    "cipher_partial_evals": ("gkr_mimc_tpu_torch/csrc/round_acc.cu",
                             "gkr_mimc_tpu/ops/kernels.py:377 cipher_partial_evals, "
                             ":1211 cipher_partial_evals_g"),
    "identity_partial_evals": ("gkr_mimc_tpu_torch/csrc/partial_evals.cu",
                               "gkr_mimc_tpu/ops/kernels.py:411 identity_partial_evals, "
                               ":1223 identity_partial_evals_g"),
    "gruen_round_scalar": ("gkr_mimc_tpu_torch/csrc/gruen_round.cu", "gkr_mimc_tpu/ops/kernels.py:1446"),
    "pow7": ("gkr_mimc_tpu_torch/csrc/sbox.cu", "gkr_mimc_tpu/ops/kernels.py:71"),
    "cipher_layer": ("gkr_mimc_tpu_torch/csrc/sbox.cu", "gkr_mimc_tpu/ops/kernels.py:89"),
    "tail_rounds": ("gkr_mimc_tpu_torch/csrc/tail.cu",
                    "gkr_mimc_tpu/sumcheck/prover.py:559 _tail_body (gkr_mimc_tpu/ops/kernels.py:89 "
                    "cipher_layer, :253 mimc_hash_fs inside it)"),
}

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Checks and launch plumbing
# ---------------------------------------------------------------------------


def _on_cpu(name: str, *tensors: torch.Tensor, dtypes=(torch.int32,)) -> bool:
    """Validate the inputs (int32 limb tensors unless ``dtypes`` says
    otherwise); True for CPU tensors (plain twin), False for CUDA tensors
    (kernel). Anything else raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))} tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _expect(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _group_size(name: str, total: int, g: int, minimum: int) -> int:
    """Entries per group of a group-major table; a power of two >= minimum."""
    if g < 1 or total % g:
        raise ValueError(f"{name}: {total} entries do not split into {g} groups")
    n = total // g
    if n < minimum or n & (n - 1):
        raise ValueError(f"{name}: group size {n} is not a power of two >= {minimum}")
    return n


def _launch(name: str, entry: str, device: torch.device, *args, counts=LAUNCHES) -> None:
    """Launch C entry ``entry`` on the current stream of ``device``; raise on
    an error, else add one to ``counts[name]``."""
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.gkr_error_string(err).decode()})")
    counts[name] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=like.device)


@lru_cache(maxsize=None)
def _binom7(device: torch.device) -> torch.Tensor:
    """C(7, m), m = 0..7, in Montgomery form: (8 limbs, 8)."""
    return fr.encode_mont_ints([math.comb(7, m) for m in range(8)], device)


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# Witness
# ---------------------------------------------------------------------------


def mimc_witness(block: torch.Tensor, state: torch.Tensor, arks: torch.Tensor) -> torch.Tensor:
    """All cipher-layer tables: block, state (8, N); arks (R, 8) Montgomery
    rows -> (R, 8, N) with s_{r+1} = (s_r + block + ark_r)^7, s_0 = state."""
    n, rounds = block.shape[-1], arks.shape[0]
    _expect("mimc_witness", block, (L, n))
    _expect("mimc_witness", state, (L, n))
    _expect("mimc_witness", arks, (rounds, L))
    if _on_cpu("mimc_witness", block, state, arks):
        return mimc_witness_plain(block, state, arks)
    out = _empty((rounds, L, n), block)
    _launch("mimc_witness", "gkr_witness", block.device,
            _ptr(block), _ptr(state), _ptr(arks), _ptr(out), n, rounds)
    return out


def mimc_witness_plain(block, state, arks):
    out = _empty((arks.shape[0], L, block.shape[-1]), block)
    s = state
    for r in range(arks.shape[0]):
        s = fr.pow7(fr.add(fr.add(s, block), arks[r].reshape(L, 1)))
        out[r] = s
    return out


# ---------------------------------------------------------------------------
# S-boxes: x^7 and the cipher-gate layer
# ---------------------------------------------------------------------------


def _table_n(name: str, x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[0] != L:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected (8, N)")
    return x.shape[1]


def pow7(x: torch.Tensor) -> torch.Tensor:
    """x^7 over an (8, N) table, as square, mul, square, mul."""
    n = _table_n("pow7", x)
    if _on_cpu("pow7", x):
        return pow7_plain(x)
    out = _empty((L, n), x)
    _launch("pow7", "gkr_pow7", x.device, _ptr(x), _ptr(out), n)
    return out


def pow7_plain(x):
    return fr.pow7(x)


def cipher_layer(l: torch.Tensor, r: torch.Tensor, ark: torch.Tensor) -> torch.Tensor:
    """One cipher-gate layer: l, r (8, N), ark (8,) -> ((r + ark) + l)^7."""
    n = _table_n("cipher_layer", l)
    _expect("cipher_layer", r, (L, n))
    _expect("cipher_layer", ark, (L,))
    if _on_cpu("cipher_layer", l, r, ark):
        return cipher_layer_plain(l, r, ark)
    out = _empty((L, n), l)
    _launch("cipher_layer", "gkr_cipher_layer", l.device, _ptr(l), _ptr(r), _ptr(ark), _ptr(out), n)
    return out


def cipher_layer_plain(l, r, ark):
    return fr.pow7(fr.add(fr.add(r, ark.reshape(L, 1)), l))


def pow7_batch(x: torch.Tensor) -> torch.Tensor:
    """``pow7`` of an (8, *S) batch of any strides: one launch over the
    batch flattened into a contiguous (8, N) table, reshaped back."""
    return pow7(x.reshape(L, -1).contiguous()).view(x.shape)


def cipher_layer_batch(l: torch.Tensor, r: torch.Tensor, ark: torch.Tensor) -> torch.Tensor:
    """``cipher_layer`` of (8, *S) batches of any strides (broadcast to one
    shape), flattened as ``pow7_batch`` does."""
    l, r = torch.broadcast_tensors(l, r)
    out = cipher_layer(l.reshape(L, -1).contiguous(), r.reshape(L, -1).contiguous(), ark.reshape(L).contiguous())
    return out.view(l.shape)


# ---------------------------------------------------------------------------
# MiMC hash (Fiat-Shamir transcript and batched lanes)
# ---------------------------------------------------------------------------


def mimc_hash(msgs: torch.Tensor) -> torch.Tensor:
    """Transcript hash MimcHash of K words: msgs (8, K) -> (8,) canonical."""
    if msgs.dim() != 2 or msgs.shape[0] != L:
        raise ValueError(f"mimc_hash: shape {tuple(msgs.shape)}, expected (8, K)")
    if _on_cpu("mimc_hash", msgs):
        return mimc_hash_plain(msgs)
    out = _empty((L, 1), msgs)
    _launch("mimc_hash", "gkr_mimc_hash", msgs.device,
            _ptr(msgs), _ptr(arks_mont(MIMC_ROUNDS, msgs.device)), _ptr(out), msgs.shape[1], 1)
    return out[:, 0]


def mimc_hash_plain(msgs):
    return mimc_hash_g_plain(msgs.reshape(L, msgs.shape[1], 1))[:, 0]


def mimc_hash_g(msgs: torch.Tensor) -> torch.Tensor:
    """G independent MimcHash lanes: msgs (8, K, G) -> (8, G) canonical."""
    if msgs.dim() != 3 or msgs.shape[0] != L:
        raise ValueError(f"mimc_hash_g: shape {tuple(msgs.shape)}, expected (8, K, G)")
    if _on_cpu("mimc_hash_g", msgs):
        return mimc_hash_g_plain(msgs)
    k, g = msgs.shape[1], msgs.shape[2]
    out = _empty((L, g), msgs)
    _launch("mimc_hash_g", "gkr_mimc_hash", msgs.device,
            _ptr(msgs), _ptr(arks_mont(MIMC_ROUNDS, msgs.device)), _ptr(out), k, g)
    return out


def mimc_hash_g_plain(msgs):
    """The chain on Python ints, lane by lane. A vectorised torch chain
    would be 3276 dependent plain multiplies per 9-word hash, seconds on a
    CPU; the host oracle is the plain reference instead."""
    from ..hashes.mimc import mimc_hash as mimc_hash_ints

    k, g = msgs.shape[1], msgs.shape[2]
    vals = fr.to_ints(msgs)  # index w * G + lane
    out = [mimc_hash_ints(vals[lane::g][:k]) for lane in range(g)]
    return fr.encode_mont_ints(out, msgs.device)


# ---------------------------------------------------------------------------
# Elementwise passes: fold, suffix step, multi-claim eq, eq-table multiply
# ---------------------------------------------------------------------------


def fold(tables: list, r: torch.Tensor) -> list:
    """Fold 1..4 group-major tables (8, G*n) on per-group challenges r
    (8, G): out = bot + r * (top - bot) per group -> [(8, G*n/2)]."""
    if not 1 <= len(tables) <= 4:
        raise ValueError(f"fold: {len(tables)} tables, expected 1..4")
    g, total = r.shape[-1], tables[0].shape[-1]
    _expect("fold", r, (L, g))
    for t in tables:
        _expect("fold", t, (L, total))
    n = _group_size("fold", total, g, 2)
    if _on_cpu("fold", r, *tables):
        return fold_plain(tables, r)
    outs = [_empty((L, total // 2), r) for _ in tables]
    ins_arr = (ctypes.c_void_p * len(tables))(*[_ptr(t) for t in tables])
    outs_arr = (ctypes.c_void_p * len(tables))(*[_ptr(o) for o in outs])
    _launch("fold", "gkr_fold", r.device, ins_arr, outs_arr, len(tables), _ptr(r), n // 2, g)
    return outs


def _halves(t: torch.Tensor, g: int):
    v = t.reshape(L, g, -1)
    h = v.shape[-1] // 2
    return v[..., :h], v[..., h:]


def fold_plain(tables, r):
    g = r.shape[-1]
    bot, top = _halves(torch.stack(tables, dim=1).reshape(L, len(tables) * g, -1), len(tables) * g)
    rr = r.reshape(L, 1, g, 1).expand(L, len(tables), g, 1).reshape(L, -1, 1)
    out = fr.add(bot, fr.mul(fr.sub(top, bot), rr)).reshape(L, len(tables), -1)
    return [o.contiguous() for o in out.unbind(1)]


def suffix_step(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One Gruen suffix doubling per group: t (8, G*m), q (8, G) ->
    (8, G*2m), group g = [t - q_g t ; q_g t] (halves concatenated)."""
    g, total = q.shape[-1], t.shape[-1]
    _expect("suffix_step", q, (L, g))
    _expect("suffix_step", t, (L, total))
    m = _group_size("suffix_step", total, g, 1)
    if _on_cpu("suffix_step", t, q):
        return suffix_step_plain(t, q)
    out = _empty((L, 2 * total), t)
    _launch("suffix_step", "gkr_suffix_step", t.device, _ptr(t), _ptr(q), _ptr(out), m, g)
    return out


def suffix_step_plain(t, q):
    g = q.shape[-1]
    tv = t.reshape(L, g, -1)
    qt = fr.mul(tv, q.reshape(L, g, 1))
    return torch.cat([fr.sub(tv, qt), qt], dim=-1).reshape(L, -1)


def multi_eq(mh: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Multi-claim eq contraction: mh (C, 8, J) per-chunk claim prefixes,
    lo (8, J, B) per-claim low tables -> (8, C*B),
    out[c*B + t] = sum_j mh[c, j] * lo[j, t]."""
    if mh.dim() != 3 or lo.dim() != 3:
        raise ValueError("multi_eq: expected mh (C, 8, J) and lo (8, J, B)")
    c, j, b = mh.shape[0], mh.shape[2], lo.shape[2]
    _expect("multi_eq", mh, (c, L, j))
    _expect("multi_eq", lo, (L, j, b))
    if _on_cpu("multi_eq", mh, lo):
        return multi_eq_plain(mh, lo)
    out = _empty((L, c * b), lo)
    _launch("multi_eq", "gkr_multi_eq", lo.device, _ptr(mh), _ptr(lo), _ptr(out), c, j, b)
    return out


def multi_eq_plain(mh, lo):
    c, _, j = mh.shape
    b = lo.shape[-1]
    acc = fr.zeros((c, b), lo.device)
    for jj in range(j):
        h = mh[:, :, jj].T.reshape(L, c, 1)
        acc = fr.add(acc, fr.mul(h, lo[:, jj].reshape(L, 1, b)))
    return acc.reshape(L, c * b)


def mul_scalar(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The eq-table doubling multiply: x (8, n) times one element r (8,)
    -> (8, n)."""
    if x.dim() != 2 or x.shape[0] != L or x.shape[1] < 1:
        raise ValueError(f"mul_scalar: shape {tuple(x.shape)}, expected (8, n)")
    _expect("mul_scalar", r, (L,))
    if _on_cpu("mul_scalar", x, r):
        return mul_scalar_plain(x, r)
    out = _empty(x.shape, x)
    _launch("mul_scalar", "gkr_mul_scalar", x.device, _ptr(x), _ptr(r), _ptr(out), x.shape[1])
    return out


def mul_scalar_plain(x, r):
    return fr.mul(x, r.reshape(L, 1))


# ---------------------------------------------------------------------------
# Round sums in coefficient form
# ---------------------------------------------------------------------------


def _blocks_per_group(half: int, g: int) -> int:
    return max(1, min(-(-half // _ACC_THREADS), 2048 // g))


def _round_geometry(name: str, tables, g: int) -> int:
    """Check equal group-major (8, G*n) tables; -> half = n/2."""
    total = tables[0].shape[-1]
    for t in tables:
        _expect(name, t, (L, total))
    return _group_size(name, total, g, 2) // 2


def _round_sums(name: str, entry: str, ns: int, g: int, half: int, ins, *extra) -> torch.Tensor:
    """Launch a two-pass round-sum kernel on its input tensors ``ins``:
    (g * bpg, ns, 8) partials scratch -> (8, ns, G)."""
    bpg = _blocks_per_group(half, g)
    partial = _empty((g * bpg, ns, L), ins[0])
    out = _empty((L, ns, g), ins[0])
    _launch(name, entry, ins[0].device, *map(_ptr, ins), _ptr(partial), _ptr(out), half, g, bpg, *extra)
    return out


def _cipher_line(x0, x1, ark, g: int):
    """Per group: u = x0_bot + x1_bot + ark, v = x0_top + x1_top + ark - u."""
    a = ark.reshape(L, g, 1)
    x0b, x0t = _halves(x0, g)
    x1b, x1t = _halves(x1, g)
    u = fr.add(fr.add(x0b, x1b), a)
    return u, fr.sub(fr.add(fr.add(x0t, x1t), a), u)


def _cipher_raws(u, v) -> torch.Tensor:
    """raw_k = u^(7-k) v^k, k = 0..7, by the product chain of
    csrc/round_acc.cu -> (8, 8, *S)."""

    def muls(pairs):  # elementwise products of several pairs in one call
        prod = fr.mul(torch.stack([x for x, _ in pairs], 1), torch.stack([y for _, y in pairs], 1))
        return prod.unbind(1)

    u2, v2, uv = muls([(u, u), (v, v), (u, v)])
    u3, v3, uv2 = muls([(u2, u), (v2, v), (uv, uv)])
    u6, v6, uv3 = muls([(u3, u3), (v3, v3), (uv, uv2)])
    return torch.stack(muls([(u6, u), (u6, v), (uv2, u3), (uv3, u), (uv3, v), (uv2, v3), (v6, u), (v6, v)]), 1)


def _deferred_blocks(half: int, g: int, device: torch.device) -> int:
    """Blocks a group of the deferred pass 1: one block an SM in all (a
    block takes 181,120 B or 220,800 B of shared memory), at most one a
    tile."""
    return max(1, min(-(-half // DEFERRED_TILE), -(-_sm_count(device) // g)))


def _deferred_partial(blocks: int, rows: int, like: torch.Tensor) -> torch.Tensor:
    """Scratch for the 64-bit byte-column sums of the deferred pass 1 with
    ``rows`` weight rows: (blocks, 8 * rows, DEFERRED_COLS)."""
    return torch.empty((blocks, 8 * rows, DEFERRED_COLS), dtype=torch.int64, device=like.device)


def _direct_round(name: str, entry: str, n_out: int, g: int, half: int, ins, *extra) -> torch.Tensor:
    """Launch a direct cipher round (pass 1 on the weight rows eq_bot and
    eq_top, then its finisher) -> (8, n_out, G) canonical."""
    bpg = _deferred_blocks(half, g, ins[0].device)
    partial = _deferred_partial(g * bpg, 2, ins[0])
    out = _empty((L, n_out, g), ins[0])
    _launch(name, entry, ins[0].device, *map(_ptr, ins), _ptr(partial), _ptr(out), half, g, bpg, *extra)
    return out


def gruen_acc(s: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, ark: torch.Tensor) -> torch.Tensor:
    """Gruen cipher round: s (8, G*n/2) suffix eq weights, x0, x1 (8, G*n),
    ark (8, G) -> Q (8, 8, G) canonical, Q_m = C(7,m) * sum_y S[y]
    u^(7-m) v^m with u = x0[y] + x1[y] + ark,
    v = x0[y+n/2] + x1[y+n/2] + ark - u."""
    g = ark.shape[-1]
    _expect("gruen_acc", ark, (L, g))
    half = _round_geometry("gruen_acc", [x0, x1], g)
    _expect("gruen_acc", s, (L, g * half))
    if _on_cpu("gruen_acc", s, x0, x1, ark):
        return gruen_acc_plain(s, x0, x1, ark)
    bpg = _deferred_blocks(half, g, s.device)
    partial = _deferred_partial(g * bpg, 1, s)
    out = _empty((L, 8, g), s)
    _launch("gruen_acc", "gkr_gruen_acc", s.device, _ptr(s), _ptr(x0), _ptr(x1), _ptr(ark), _ptr(partial),
            _ptr(out), half, g, bpg)
    return out


def gruen_acc_plain(s, x0, x1, ark):
    g = ark.shape[-1]
    raws = _cipher_raws(*_cipher_line(x0, x1, ark, g))  # (8, 8, G, half)
    sums = fr.reduce_sum(fr.mul(s.reshape(L, 1, g, -1), raws), 2)  # (8, 8, G)
    return fr.canonicalize(fr.mul(sums, _binom7(s.device).reshape(L, 8, 1)))


def cipher_coeff_acc(eq: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, ark: torch.Tensor,
                     g: int) -> torch.Tensor:
    """Direct cipher round in coefficient form: eq, x0, x1 (8, G*n), ark
    (8, G) -> P (8, 9, G) canonical. With e = eq_bot, de = eq_top - e and
    u, v as in ``gruen_acc``, P(t) = (e + t de) (u + t v)^7 summed over the
    half cube: P_m = <e, C(7,m) raw_m> + <de, C(7,m-1) raw_(m-1)>,
    raw_k = u^(7-k) v^k."""
    _expect("cipher_coeff_acc", ark, (L, g))
    half = _round_geometry("cipher_coeff_acc", [eq, x0, x1], g)
    if _on_cpu("cipher_coeff_acc", eq, x0, x1, ark):
        return cipher_coeff_acc_plain(eq, x0, x1, ark, g)
    return _direct_round("cipher_coeff_acc", "gkr_cipher_coeff_acc", 9, g, half, [eq, x0, x1, ark])


def cipher_coeff_acc_plain(eq, x0, x1, ark, g):
    raws = _cipher_raws(*_cipher_line(x0, x1, ark, g)).unbind(1)
    scaled = torch.stack([fr.mul_small(raw, math.comb(7, k)) for k, raw in enumerate(raws)], 1)
    eb, et = _halves(eq, g)
    e_sums = fr.reduce_sum(fr.mul(eb.unsqueeze(1), scaled), 2)  # (8, 8, G)
    de_sums = fr.reduce_sum(fr.mul(fr.sub(et, eb).unsqueeze(1), scaled), 2)
    zero = fr.zeros((1, g), eq.device)
    return fr.canonicalize(fr.add(torch.cat([e_sums, zero], 1), torch.cat([zero, de_sums], 1)))


def identity_acc(eq: torch.Tensor, x: torch.Tensor, g: int) -> torch.Tensor:
    """Identity round in coefficient form: eq, x (8, G*n) -> P (8, 3, G)
    with e = eq_bot, de = eq_top - e, u = x_bot, v = x_top - u:
    P0 = <e,u>, P1 = <e,v> + <de,u>, P2 = <de,v>."""
    half = _round_geometry("identity_acc", [eq, x], g)
    if _on_cpu("identity_acc", eq, x):
        return identity_acc_plain(eq, x, g)
    return _round_sums("identity_acc", "gkr_identity_acc", 3, g, half, [eq, x])


def identity_acc_plain(eq, x, g):
    bot, top = _halves(torch.stack([eq, x], 1).reshape(L, 2 * g, -1), 2 * g)
    diff = fr.sub(top, bot).reshape(L, 2, g, -1)
    e, u = bot.reshape(L, 2, g, -1).unbind(1)
    de, v = diff.unbind(1)
    eu, ev, deu, dev = fr.mul(torch.stack([e, e, de, de], 1), torch.stack([u, v, u, v], 1)).unbind(1)
    terms = torch.stack([eu, fr.add(ev, deu), dev], 1)  # (8, 3, G, half)
    return fr.reduce_sum(terms, 2)


# ---------------------------------------------------------------------------
# Round sums in evaluation form
# ---------------------------------------------------------------------------

CIPHER_EVALS = 9  # the cipher gate's degree 7, plus 2
IDENTITY_EVALS = 3


def stack_t(tables: torch.Tensor, n_evals: int, skip_t0: bool = False) -> torch.Tensor:
    """(8, T, G, 2m) -> (8, T, n_out, G, m): the restriction of each table
    to the leading variable at t = 0 (unless skip_t0), 1, ..., n_evals - 1,
    by repeated adds of (top - bot)."""
    m = tables.shape[-1] // 2
    bot, top = tables[..., :m], tables[..., m:]
    d = fr.sub(top, bot)
    rows = [bot, top]
    for _ in range(n_evals - 2):
        rows.append(fr.add(rows[-1], d))
    return torch.stack(rows[1:] if skip_t0 else rows, dim=2)


def _check_evals(name: str, n_evals: int, want: int) -> None:
    if n_evals != want:
        raise ValueError(f"{name}: n_evals {n_evals}, expected {want} (the gate's degree + 2)")


def cipher_partial_evals(eq: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, ark: torch.Tensor,
                         g: int, n_evals: int, skip_t0: bool) -> torch.Tensor:
    """Cipher round in evaluation form: eq, x0, x1 (8, G*n), ark (8, G) ->
    (8, n_evals - skip_t0, G) canonical, column t the sum over the half
    cube of eq_t * (x0_t + x1_t + ark)^7, a_t = a_bot + t (a_top - a_bot),
    at t = 0..n_evals-1 (1..n_evals-1 with skip_t0: the claim trick). The
    kernel sums the coefficients as ``cipher_coeff_acc`` does and evaluates
    them at t."""
    _check_evals("cipher_partial_evals", n_evals, CIPHER_EVALS)
    _expect("cipher_partial_evals", ark, (L, g))
    half = _round_geometry("cipher_partial_evals", [eq, x0, x1], g)
    if _on_cpu("cipher_partial_evals", eq, x0, x1, ark):
        return cipher_partial_evals_plain(eq, x0, x1, ark, g, n_evals, skip_t0)
    return _direct_round("cipher_partial_evals", "gkr_cipher_partial_evals", n_evals - bool(skip_t0), g,
                         half, [eq, x0, x1, ark], n_evals, int(bool(skip_t0)))


def cipher_partial_evals_plain(eq, x0, x1, ark, g, n_evals, skip_t0):
    return fr.canonicalize(cipher_evals_per_t(eq, x0, x1, ark, g, n_evals, skip_t0))


def cipher_evals_per_t(eq, x0, x1, ark, g, n_evals, skip_t0):
    """The cipher round's sums at each t, the S-box at every t (lazy, below
    2p): the function of the per-t kernel that the multiply probe runs
    (csrc/partial_evals.cu, ``probes.cipher_pe_variant``)."""
    e, u, w = stack_t(torch.stack([eq, x0, x1], 1).reshape(L, 3, g, -1), n_evals, skip_t0).unbind(1)
    gate = fr.pow7(fr.add(fr.add(w, ark.reshape(L, 1, g, 1)), u))
    return fr.reduce_sum(fr.mul(e, gate), 2)  # (8, n_out, G)


def identity_partial_evals(eq: torch.Tensor, x: torch.Tensor, g: int, n_evals: int,
                           skip_t0: bool) -> torch.Tensor:
    """Identity round in evaluation form: eq, x (8, G*n) ->
    (8, n_evals - skip_t0, G), column t the sum of eq_t * x_t."""
    _check_evals("identity_partial_evals", n_evals, IDENTITY_EVALS)
    half = _round_geometry("identity_partial_evals", [eq, x], g)
    if _on_cpu("identity_partial_evals", eq, x):
        return identity_partial_evals_plain(eq, x, g, n_evals, skip_t0)
    return _round_sums("identity_partial_evals", "gkr_identity_partial_evals", n_evals - bool(skip_t0), g,
                       half, [eq, x], n_evals, int(bool(skip_t0)))


def identity_partial_evals_plain(eq, x, g, n_evals, skip_t0):
    e, u = stack_t(torch.stack([eq, x], 1).reshape(L, 2, g, -1), n_evals, skip_t0).unbind(1)
    return fr.reduce_sum(fr.mul(e, u), 2)


# ---------------------------------------------------------------------------
# Gruen round scalar stage
# ---------------------------------------------------------------------------


def gruen_round_scalar(qc: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, ck: torch.Tensor,
                       qk: torch.Tensor):
    """The scalar stage of a Gruen head round in G lanes: qc (8, 8, G) the
    C(7,m)-scaled round sums Q_m; alpha = 1 - q_k, beta = 2 q_k - 1, ck,
    q_k (8, G) -> (P (8, 9, G) with P_m = ck (alpha Q_m + beta Q_{m-1}),
    r = MimcHash(P) (8, G) canonical, ck' = ck eq1(q_k, r) (8, G))."""
    if qc.dim() != 3:
        raise ValueError(f"gruen_round_scalar: shape {tuple(qc.shape)}, expected (8, 8, G)")
    g = qc.shape[-1]
    _expect("gruen_round_scalar", qc, (L, 8, g))
    for t in (alpha, beta, ck, qk):
        _expect("gruen_round_scalar", t, (L, g))
    if _on_cpu("gruen_round_scalar", qc, alpha, beta, ck, qk):
        return gruen_round_scalar_plain(qc, alpha, beta, ck, qk)
    p, r, ck2 = _empty((L, 9, g), qc), _empty((L, g), qc), _empty((L, g), qc)
    _launch("gruen_round_scalar", "gkr_gruen_round", qc.device, _ptr(qc), _ptr(alpha), _ptr(beta),
            _ptr(ck), _ptr(qk), _ptr(arks_mont(MIMC_ROUNDS, qc.device)), _ptr(p), _ptr(r), _ptr(ck2), g)
    return p, r, ck2


def _gruen_combine(qc, alpha, beta, ck):
    """Q (8, 8, G) -> P (8, 9, G): P_m = ck (alpha Q_m + beta Q_{m-1})."""
    zero = fr.zeros((1, qc.shape[-1]), qc.device)
    p = fr.add(
        torch.cat([fr.mul(qc, alpha.unsqueeze(1)), zero], dim=1),
        torch.cat([zero, fr.mul(qc, beta.unsqueeze(1))], dim=1),
    )
    return fr.mul(p, ck.unsqueeze(1))


def _eq1_at(qk, r):
    """eq1(q, r) = 1 - q - r + 2 q r."""
    one = fr.one(qk.shape[1:], qk.device)
    t = fr.mul(qk, r)
    return fr.add(fr.sub(fr.sub(one, qk), r), fr.add(t, t))


def gruen_round_scalar_plain(qc, alpha, beta, ck, qk):
    """The unfused stage: the combine, the transcript hash of each lane,
    then eq1 (the reference's GKR_GRUEN_FUSE=0 path)."""
    p = _gruen_combine(qc, alpha, beta, ck)
    r = mimc_hash_g_plain(p)
    return p, r, fr.mul(ck, _eq1_at(qk, r))


# ---------------------------------------------------------------------------
# The tail rounds of a cipher or identity layer
# ---------------------------------------------------------------------------

TAIL_MAX_BITS = 10  # tables of at most 2**TAIL_MAX_BITS entries fit the tail kernel's shared memory


def generic_round(evaluate, n_evals: int, eq: torch.Tensor, xs: list, challenge):
    """One evaluation-form sumcheck round on (8, G, n) tables in plain torch
    field ops: the tables at t = 0..n_evals-1, the gate ``evaluate(xs_t)``,
    the sums of eq_t * gate, interpolation, the challenge
    ``challenge(coeffs)`` and the folds bot + r (top - bot). Returns (eq,
    xs, coeffs (8, n_evals, G), r (8, G))."""
    tables = torch.stack([eq] + list(xs), dim=1)  # (8, 1 + k, G, n)
    at_t = stack_t(tables, n_evals)
    g = evaluate(list(at_t[:, 1:].unbind(1)))
    evals = fr.reduce_sum(fr.mul(at_t[:, 0], g), 2)  # (8, n_evals, G)
    coeffs = lagrange.interpolate_on_range_device(evals)
    r = challenge(coeffs)
    half = tables.shape[-1] // 2
    bot, top = tables[..., :half], tables[..., half:]
    folded = fr.add(bot, fr.mul(fr.sub(top, bot), r.reshape(L, 1, -1, 1))).unbind(1)
    return folded[0], list(folded[1:]), coeffs, r


def _tail_evals(name: str, eq: torch.Tensor, xs: list, ark) -> int:
    """Check the tail's tables and gate: eq and k tables (8, G, m),
    2 <= m <= 2**TAIL_MAX_BITS a power of two; ark (8,) with k = 2 (cipher
    gate), None with k = 1 (identity gate). Returns the number of
    evaluations a round."""
    if (len(xs), ark is None) not in ((2, False), (1, True)):
        raise ValueError(f"{name}: expected x0, x1 and an ark (cipher) or x0 and no ark (identity)")
    if eq.dim() != 3 or eq.shape[0] != L:
        raise ValueError(f"{name}: eq shape {tuple(eq.shape)}, expected (8, G, m)")
    m = eq.shape[2]
    if not 2 <= m <= 1 << TAIL_MAX_BITS or m & (m - 1):
        raise ValueError(f"{name}: table size {m} is not a power of two in [2, 2^{TAIL_MAX_BITS}]")
    for x in xs:
        _expect(name, x, eq.shape)
    if ark is not None:
        _expect(name, ark, (L,))
    return CIPHER_EVALS if ark is not None else IDENTITY_EVALS


def tail_rounds(eq: torch.Tensor, xs: list, ark) -> tuple:
    """Every remaining round of a layer whose tables are small: eq and xs
    (8, G, m), the cipher gate ((x1 + ark) + x0)^7 over xs = [x0, x1] with
    ark (8,), or the identity gate over xs = [x0] with ark None. Returns
    the log2(m) rounds' coefficients (s, 8, E, G) (E = 9 or 3) and
    challenges (s, 8, G, canonical), and the final values of eq and the
    tables (1 + k, 8, G): what s generic rounds give."""
    n_evals = _tail_evals("tail_rounds", eq, xs, ark)
    if _on_cpu("tail_rounds", eq, *xs, *([] if ark is None else [ark])):
        return tail_rounds_plain(eq, xs, ark)
    g, m = eq.shape[1], eq.shape[2]
    s = m.bit_length() - 1
    coeffs, rs, finals = _empty((s, L, n_evals, g), eq), _empty((s, L, g), eq), _empty((1 + len(xs), L, g), eq)
    _launch("tail_rounds", "gkr_tail_rounds", eq.device, _ptr(eq), _ptr(xs[0]), _ptr(xs[-1]),
            None if ark is None else _ptr(ark), _ptr(lagrange.lagrange_tensor(n_evals, eq.device)),
            _ptr(arks_mont(MIMC_ROUNDS, eq.device)), _ptr(coeffs), _ptr(rs), _ptr(finals), m, g, len(xs))
    return coeffs, rs, finals


def tail_rounds_plain(eq, xs, ark):
    """The loop of ``generic_round`` over the tail, the cipher gate as
    ``cipher_layer_plain`` computes it and the challenge on host ints."""
    n_evals = _tail_evals("tail_rounds_plain", eq, xs, ark)

    def evaluate(xs_t):
        if ark is None:
            return xs_t[0]
        return fr.pow7(fr.add(fr.add(xs_t[1], ark.reshape((L,) + (1,) * (xs_t[1].dim() - 1))), xs_t[0]))

    coeffs, rs = [], []
    while eq.shape[-1] > 1:
        eq, xs, c, r = generic_round(evaluate, n_evals, eq, xs, mimc_hash_g_plain)
        coeffs.append(c)
        rs.append(r)
    return torch.stack(coeffs), torch.stack(rs), torch.stack([eq[:, :, 0]] + [x[:, :, 0] for x in xs])


PLAIN = {
    "mimc_witness": mimc_witness_plain,
    "mimc_hash": mimc_hash_plain,
    "mimc_hash_g": mimc_hash_g_plain,
    "fold": fold_plain,
    "suffix_step": suffix_step_plain,
    "multi_eq": multi_eq_plain,
    "mul_scalar": mul_scalar_plain,
    "gruen_acc": gruen_acc_plain,
    "cipher_coeff_acc": cipher_coeff_acc_plain,
    "identity_acc": identity_acc_plain,
    "cipher_partial_evals": cipher_partial_evals_plain,
    "identity_partial_evals": identity_partial_evals_plain,
    "gruen_round_scalar": gruen_round_scalar_plain,
    "pow7": pow7_plain,
    "cipher_layer": cipher_layer_plain,
    "tail_rounds": tail_rounds_plain,
}
