"""The Gruen round's deferred-reduction algorithm (csrc/round_acc.cu,
namespace deferred, one weight row) as a Python-int model, held equal to
the plain twin ``gruen_acc_plain``.

The CUDA kernel cannot run here. This model follows its arithmetic step by
step: the 8 raws u^(7-m) v^m left unreduced (512-bit products of the same
factors), their words and the byte windows of S, the per-point digit sums
of the tensor-core contraction (byte 4 w + q of a raw times byte j - q of S,
weight 2^(8 (4 w + j))), the s32 sums flushed every DEFERRED_FLUSH_POINTS
points, the 100 byte columns of a block's partial, the carry into one wide
integer of DEFERRED_WIDE_WORDS words, three REDCs, the multiple by C(7, m)
and the product by R^2, canonical. It checks each headroom the kernel relies on as it
goes.
"""

import math

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import NPRIME, P, R2
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.ops.probes import LAZY_EDGES

R = 1 << 256
RAW_WORDS, WINDOWS, COLS = 16, 40, K.DEFERRED_COLS


def _redc(t: int) -> int:
    """REDC by R with the unique m < R: the integer of fr::mul and of the
    kernel's word-by-word redc_shift."""
    return (t + ((t * NPRIME) & (R - 1)) * P) >> 256


def _raw_factors(x0, x1, ark, g):
    """The two lazy factors of each raw, paired as CipherPowers::raw_wide
    pairs them, each (8, G, half)."""
    u, v = K._cipher_line(x0, x1, ark, g)
    u2, v2, uv = fr.mul(u, u), fr.mul(v, v), fr.mul(u, v)
    u3, v3, uv2 = fr.mul(u2, u), fr.mul(v2, v), fr.mul(uv, uv)
    u6, v6, uv3 = fr.mul(u3, u3), fr.mul(v3, v3), fr.mul(uv, uv2)
    return [(u6, u), (u6, v), (uv2, u3), (uv3, u), (uv3, v), (uv2, v3), (v6, u), (v6, v)]


def _bytes(values, width: int) -> np.ndarray:
    raw = b"".join(int(x).to_bytes(width, "little") for x in values)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(values), width).astype(np.int64)


def _digit_sums(raws, s_vals, tile: int, flush_points: int) -> np.ndarray:
    """Pass 1 of one block over all points: D[w][j] of one raw, with the s32
    sums checked below 2^31 at every flush."""
    a = _bytes(raws, 4 * RAW_WORDS).reshape(len(raws), RAW_WORDS, 4)  # byte 4 w + q
    sb = _bytes(s_vals, 32)
    win = np.zeros((len(raws), WINDOWS, 4), dtype=np.int64)  # byte q of window j = byte j - q of S
    for j in range(WINDOWS):
        for q in range(4):
            if 0 <= j - q < 32:
                win[:, j, q] = sb[:, j - q]
    per_point = np.einsum("pwq,pjq->pwj", a, win)
    assert per_point.max() <= 4 * 255**2
    pad = -len(raws) % tile  # the kernel's last tile: zero raws past the end
    per_point = np.concatenate([per_point, np.zeros((pad, RAW_WORDS, WINDOWS), dtype=np.int64)])
    total = np.zeros((RAW_WORDS, WINDOWS), dtype=np.uint64)
    for start in range(0, len(per_point), flush_points):
        s32 = per_point[start : start + flush_points].sum(axis=0)
        assert s32.max() < 1 << 31  # the mma's s32 sums
        total += s32.astype(np.uint64)
    return total


def _columns(d: np.ndarray) -> list:
    """The block's partial of one raw: byte column c = 4 w + j."""
    cols = [0] * COLS
    for w in range(RAW_WORDS):
        for j in range(WINDOWS):
            cols[4 * w + j] += int(d[w, j])
    assert max(cols) < 1 << 64
    return cols


def _finish(cols: list, m: int) -> int:
    """Pass 2 of one raw: carry the columns into DEFERRED_WIDE_WORDS 32-bit
    words, three REDCs, C(7, m) times it mod 2p, one product by R^2,
    canonical."""
    words, carry = [], 0
    for k in range(K.DEFERRED_WIDE_WORDS):
        word = 0
        for b in range(4):
            c = 4 * k + b
            x = (cols[c] if c < COLS else 0) + carry
            word |= (x & 0xFF) << (8 * b)
            carry = x >> 8
        words.append(word)
    assert carry == 0
    t = sum(w << (32 * k) for k, w in enumerate(words))
    for _ in range(3):
        assert t + (R - 1) * P < 1 << (32 * K.DEFERRED_WIDE_WORDS)
        t = _redc(t)
    assert t < 2 * P
    q = _redc((math.comb(7, m) * t % (2 * P)) * R2)
    assert q < 2 * P
    return q - P if q >= P else q


def deferred_model(s, x0, x1, ark, tile=K.DEFERRED_TILE, flush_points=K.DEFERRED_FLUSH_POINTS):
    """Q (8 coefficients, G) canonical ints, by the kernel's arithmetic."""
    g = ark.shape[-1]
    factors = [(fr.limb_values(a.reshape(8, -1)), fr.limb_values(b.reshape(8, -1)))
               for a, b in _raw_factors(x0, x1, ark, g)]
    s_all = fr.limb_values(s)
    half = len(s_all) // g
    out = []
    for m, (fa, fb) in enumerate(factors):
        row = []
        for grp in range(g):
            pts = range(grp * half, (grp + 1) * half)
            raws = [fa[i] * fb[i] for i in pts]
            assert max(raws) < 1 << 512
            s_vals = [s_all[i] for i in pts]
            cols = _columns(_digit_sums(raws, s_vals, tile, flush_points))
            assert sum(c << (8 * i) for i, c in enumerate(cols)) == sum(a * b for a, b in zip(s_vals, raws))
            row.append(_finish(cols, m))
        out.append(row)
    return out


def _lazy(rng, n):
    limbs = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    limbs[7] %= 0x60C89CE5  # below the top limb of 2p
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32))


def _plain_ints(s, x0, x1, ark):
    q = K.gruen_acc_plain(s, x0, x1, ark)  # (8, 8, G)
    g = ark.shape[-1]
    return [[fr.limb_values(q[:, m, grp].reshape(8, 1).contiguous())[0] for grp in range(g)] for m in range(8)]


@pytest.mark.parametrize("g", [1, 2])
def test_deferred_model_matches_plain(g):
    rng = np.random.default_rng(60 + g)
    n = 16
    s, x0, x1, ark = _lazy(rng, g * n // 2), _lazy(rng, g * n), _lazy(rng, g * n), _lazy(rng, g)
    want = _plain_ints(s, x0, x1, ark)
    assert all(v < P for row in want for v in row)
    assert deferred_model(s, x0, x1, ark) == want
    # the same sums with tiles of 2 points flushed every 4: the flush path
    assert deferred_model(s, x0, x1, ark, tile=2, flush_points=4) == want


def test_deferred_model_at_lazy_edges_and_headroom():
    """All inputs 2p - 1, then S = 2p - 1 with x0, x1, ark over the lazy
    edges; and the kernel's headroom constants: a flush interval of s32
    digit sums, the 64-bit columns and the wide integer at 2^30 points."""
    n, top = 16, 2 * P - 1
    edge = fr._limb_tensor([top] * n)
    s = fr._limb_tensor([top] * (n // 2))
    ark = fr._limb_tensor([top])
    assert deferred_model(s, edge, edge, ark) == _plain_ints(s, edge, edge, ark)
    cyc = [LAZY_EDGES[i % len(LAZY_EDGES)] for i in range(2 * n)]
    x0, x1 = fr._limb_tensor(cyc[:n]), fr._limb_tensor(cyc[n:][::-1])
    for a in (top, LAZY_EDGES[3]):
        ark = fr._limb_tensor([a])
        assert deferred_model(s, x0, x1, ark) == _plain_ints(s, x0, x1, ark)
    # headroom of the CUDA constants
    assert K.DEFERRED_FLUSH_POINTS % K.DEFERRED_TILE == 0
    assert K.DEFERRED_FLUSH_POINTS * 4 * 255**2 < 1 << 31
    points = 1 << 30
    assert points * 32 * 255**2 < 1 << 64  # a byte column: at most 32 byte pairs a point
    assert points * (2 * P) * (4 * P * P) + (R - 1) * P < 1 << (32 * K.DEFERRED_WIDE_WORDS)
    assert (1 << 800) > points * (2 * P) * (4 * P * P)  # finish_kernel's comment
