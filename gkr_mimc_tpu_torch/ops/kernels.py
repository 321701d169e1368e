"""The main path's CUDA kernels: one wrapper per kernel, each beside its
plain torch twin.

Every Pallas kernel that the reference's default path reaches has a
hand-written CUDA counterpart in ``csrc/`` (compiled for sm_90a by
``ops/build.py``):

==============  =====================  =========================================
wrapper         CUDA source            replaces (gkr_mimc_tpu/ops/kernels.py)
==============  =====================  =========================================
mimc_witness    csrc/witness.cu        mimc_witness (:136)
mimc_hash       csrc/mimc_hash.cu      mimc_hash_fs (:253), G = 1
mimc_hash_g     csrc/mimc_hash.cu      mimc_hash_fs_g (:1321), G lanes
fold            csrc/elementwise.cu    fold_tables_band (:935)
suffix_step     csrc/elementwise.cu    suffix_step_band (:1000)
multi_eq        csrc/elementwise.cu    multi_eq_accum (:1588)
gruen_acc       csrc/round_acc.cu      cipher_gruen_acc (:740) + finish_gruen_acc
identity_acc    csrc/round_acc.cu      identity_coeff_acc (:651) + finish_coeff_acc
==============  =====================  =========================================

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current CUDA stream, raises if the C entry returns a non-zero
``cudaError_t``, and adds one to ``LAUNCHES[name]``. It takes its plain twin
(``<name>_plain``, same signature, same output bits) only for tensors on
the CPU. Callers reach the wrappers through this module's attributes
(``K.fold(...)``), so a caller's check can swap in the plain twins.

Tables are group-major: an (8, G*n) table holds G groups of n entries, and
a per-group scalar is an (8, G) tensor.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from ..fields import fr
from ..fields.bn254 import L
from ..hashes.ark import arks_mont
from . import build

MIMC_ROUNDS = 91
_ACC_THREADS = 256  # threads per block of csrc/round_acc.cu

# wrapper -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "mimc_witness": ("gkr_mimc_tpu_torch/csrc/witness.cu", "gkr_mimc_tpu/ops/kernels.py:136"),
    "mimc_hash": ("gkr_mimc_tpu_torch/csrc/mimc_hash.cu", "gkr_mimc_tpu/ops/kernels.py:253"),
    "mimc_hash_g": ("gkr_mimc_tpu_torch/csrc/mimc_hash.cu", "gkr_mimc_tpu/ops/kernels.py:1321"),
    "fold": ("gkr_mimc_tpu_torch/csrc/elementwise.cu", "gkr_mimc_tpu/ops/kernels.py:935"),
    "suffix_step": ("gkr_mimc_tpu_torch/csrc/elementwise.cu", "gkr_mimc_tpu/ops/kernels.py:1000"),
    "multi_eq": ("gkr_mimc_tpu_torch/csrc/elementwise.cu", "gkr_mimc_tpu/ops/kernels.py:1588"),
    "gruen_acc": ("gkr_mimc_tpu_torch/csrc/round_acc.cu", "gkr_mimc_tpu/ops/kernels.py:740"),
    "identity_acc": ("gkr_mimc_tpu_torch/csrc/round_acc.cu", "gkr_mimc_tpu/ops/kernels.py:651"),
}

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Checks and launch plumbing
# ---------------------------------------------------------------------------


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """Validate the inputs; True for CPU tensors (plain twin), False for
    CUDA tensors (kernel). Anything else raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limb tensors, got {t.dtype}")
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


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.gkr_error_string(err).decode()})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=like.device)


@lru_cache(maxsize=None)
def _binom7(device: torch.device) -> torch.Tensor:
    """C(7, m), m = 0..7, in Montgomery form: (8 limbs, 8)."""
    return fr.encode_mont_ints([math.comb(7, m) for m in range(8)], device)


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
# Elementwise passes: fold, suffix step, multi-claim eq
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


# ---------------------------------------------------------------------------
# Round accumulators
# ---------------------------------------------------------------------------


def _blocks_per_group(half: int, g: int) -> int:
    return max(1, min(-(-half // _ACC_THREADS), 2048 // g))


def gruen_acc(s: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, ark: torch.Tensor) -> torch.Tensor:
    """Gruen cipher round: s (8, G*n/2) suffix eq weights, x0, x1 (8, G*n),
    ark (8, G) -> Q (8, 8, G), Q_m = C(7,m) * sum_y S[y] u^(7-m) v^m with
    u = x0[y] + x1[y] + ark, v = x0[y+n/2] + x1[y+n/2] + ark - u."""
    g, total = ark.shape[-1], x0.shape[-1]
    _expect("gruen_acc", ark, (L, g))
    _expect("gruen_acc", x0, (L, total))
    _expect("gruen_acc", x1, (L, total))
    _expect("gruen_acc", s, (L, total // 2))
    half = _group_size("gruen_acc", total, g, 2) // 2
    if _on_cpu("gruen_acc", s, x0, x1, ark):
        return gruen_acc_plain(s, x0, x1, ark)
    bpg = _blocks_per_group(half, g)
    partial = _empty((g * bpg, 8, L), s)
    out = _empty((L, 8, g), s)
    binom_rows = _binom7(s.device).T.contiguous()
    _launch("gruen_acc", "gkr_gruen_acc", s.device, _ptr(s), _ptr(x0), _ptr(x1), _ptr(ark),
            _ptr(binom_rows), _ptr(partial), _ptr(out), half, g, bpg)
    return out


def gruen_acc_plain(s, x0, x1, ark):
    g = ark.shape[-1]
    a = ark.reshape(L, g, 1)
    x0b, x0t = _halves(x0, g)
    x1b, x1t = _halves(x1, g)
    u = fr.add(fr.add(x0b, x1b), a)
    v = fr.sub(fr.add(fr.add(x0t, x1t), a), u)
    w = s.reshape(L, 1, g, -1)

    def muls(pairs):  # elementwise products of several pairs in one call
        prod = fr.mul(torch.stack([x for x, _ in pairs], 1), torch.stack([y for _, y in pairs], 1))
        return prod.unbind(1)

    # the product chain of csrc/round_acc.cu
    u2, v2, uv = muls([(u, u), (v, v), (u, v)])
    u3, v3, uv2 = muls([(u2, u), (v2, v), (uv, uv)])
    u6, v6, uv3 = muls([(u3, u3), (v3, v3), (uv, uv2)])
    raws = muls([(u6, u), (u6, v), (uv2, u3), (uv3, u), (uv3, v), (uv2, v3), (v6, u), (v6, v)])
    sums = fr.reduce_sum(fr.mul(w, torch.stack(raws, 1)), 2)  # (8, 8, G)
    return fr.mul(sums, _binom7(s.device).reshape(L, 8, 1))


def identity_acc(eq: torch.Tensor, x: torch.Tensor, g: int) -> torch.Tensor:
    """Identity round in coefficient form: eq, x (8, G*n) -> P (8, 3, G)
    with e = eq_bot, de = eq_top - e, u = x_bot, v = x_top - u:
    P0 = <e,u>, P1 = <e,v> + <de,u>, P2 = <de,v>."""
    total = eq.shape[-1]
    _expect("identity_acc", eq, (L, total))
    _expect("identity_acc", x, (L, total))
    half = _group_size("identity_acc", total, g, 2) // 2
    if _on_cpu("identity_acc", eq, x):
        return identity_acc_plain(eq, x, g)
    bpg = _blocks_per_group(half, g)
    partial = _empty((g * bpg, 3, L), eq)
    out = _empty((L, 3, g), eq)
    _launch("identity_acc", "gkr_identity_acc", eq.device,
            _ptr(eq), _ptr(x), _ptr(partial), _ptr(out), half, g, bpg)
    return out


def identity_acc_plain(eq, x, g):
    bot, top = _halves(torch.stack([eq, x], 1).reshape(L, 2 * g, -1), 2 * g)
    diff = fr.sub(top, bot).reshape(L, 2, g, -1)
    e, u = bot.reshape(L, 2, g, -1).unbind(1)
    de, v = diff.unbind(1)
    eu, ev, deu, dev = fr.mul(torch.stack([e, e, de, de], 1), torch.stack([u, v, u, v], 1)).unbind(1)
    terms = torch.stack([eu, fr.add(ev, deu), dev], 1)  # (8, 3, G, half)
    return fr.reduce_sum(terms, 2)


PLAIN = {
    "mimc_witness": mimc_witness_plain,
    "mimc_hash": mimc_hash_plain,
    "mimc_hash_g": mimc_hash_g_plain,
    "fold": fold_plain,
    "suffix_step": suffix_step_plain,
    "multi_eq": multi_eq_plain,
    "gruen_acc": gruen_acc_plain,
    "identity_acc": identity_acc_plain,
}
