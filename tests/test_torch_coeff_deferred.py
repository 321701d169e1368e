"""The direct cipher rounds' deferred-reduction algorithm (csrc/round_acc.cu,
namespace deferred, two weight rows, and coeff_finish_kernel) as a
Python-int model, held equal to the plain twins ``cipher_coeff_acc_plain``
and ``cipher_partial_evals_plain``.

The CUDA kernel cannot run here. This model follows its arithmetic step by
step: the 8 raws u^(7-m) v^m left unreduced (512-bit products of the same
factors); the 35 byte windows of e = eq[bot] and of et = eq[top], packed
into 9 tiles of 8 columns (window column 35 r + j, two zero columns); the
per-point digit sums of the tensor-core contraction (byte 4 w + q of a raw
times byte j - q of a weight); the s32 sums of each block (tiles dealt out
grid-stride) flushed every DEFERRED_FLUSH_POINTS points into the byte
columns 4 w + j of sum m W + r; the blocks' partials added; the carry into
one integer of DEFERRED_WIDE_WORDS words; three REDCs to the plain values
A_m = <e, raw_m> and T_m = <et, raw_m>; the coefficients
c_m = C(7, m) A_m + C(7, m - 1) (T_(m-1) - A_(m-1)) by the kernel's adds
mod 2p and one REDC by R^2; and the values at t by Horner's rule, canonical.
It checks each headroom the kernel relies on as it goes.

    python -m pytest tests/test_torch_coeff_deferred.py -q -p no:cacheprovider
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
RAW_WORDS, WIN, COLS, ROWS = 16, K.DEFERRED_WINDOWS, K.DEFERRED_COLS, 2
N_TILES = -(-ROWS * WIN // 8)  # 9 tiles of 8 window columns
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on the H100


def _redc(t: int) -> int:
    """REDC by R with the unique m < R: the integer of fr::mul and of the
    kernel's word-by-word redc_shift."""
    return (t + ((t * NPRIME) & (R - 1)) * P) >> 256


def _mod2p(x: int) -> int:
    """The representative in [0, 2p) of fr::add, fr::sub and fr::mul_small."""
    return x % (2 * P)


def _bytes(values, width: int) -> np.ndarray:
    raw = b"".join(int(x).to_bytes(width, "little") for x in values)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(values), width).astype(np.int64)


def _raws(x0, x1, ark, g) -> list:
    """raw_m as ints, (8 raws) x (G * half points): the two lazy factors of
    CipherPowers::raw_wide, multiplied unreduced."""
    u, v = K._cipher_line(x0, x1, ark, g)
    u2, v2, uv = fr.mul(u, u), fr.mul(v, v), fr.mul(u, v)
    u3, v3, uv2 = fr.mul(u2, u), fr.mul(v2, v), fr.mul(uv, uv)
    u6, v6, uv3 = fr.mul(u3, u3), fr.mul(v3, v3), fr.mul(uv, uv2)
    pairs = [(u6, u), (u6, v), (uv2, u3), (uv3, u), (uv3, v), (uv2, v3), (v6, u), (v6, v)]
    out = []
    for a, b in pairs:
        fa, fb = fr.limb_values(a.reshape(8, -1)), fr.limb_values(b.reshape(8, -1))
        out.append([x * y for x, y in zip(fa, fb)])
    assert max(max(r) for r in out) < 1 << 512
    return out


def _windows(weights: list) -> np.ndarray:
    """(points, 8 * N_TILES, 4): byte q of window column 35 r + j is byte
    j - q of weight row r, zero outside 0..31; the last columns zero."""
    win = np.zeros((len(weights[0]), 8 * N_TILES, 4), dtype=np.int64)
    for r, vals in enumerate(weights):
        wb = _bytes(vals, 32)
        for j in range(WIN):
            for q in range(4):
                if 0 <= j - q < 32:
                    win[:, WIN * r + j, q] = wb[:, j - q]
    return win


def _block_columns(raw: list, weights: list, tile: int, flush_points: int, bpg: int) -> list:
    """Pass 1 of one raw over one group: the byte columns [row][4 w + j]
    added over the group's bpg blocks, each block's s32 digit sums checked
    below 2^31 at every flush."""
    a = _bytes(raw, 4 * RAW_WORDS).reshape(len(raw), RAW_WORDS, 4)  # byte 4 w + q
    per_point = np.einsum("pwq,pcq->pwc", a, _windows(weights))
    assert per_point.max() <= 4 * 255**2
    pad = -len(raw) % tile  # the last tile: zero raws past the end
    per_point = np.concatenate([per_point, np.zeros((pad,) + per_point.shape[1:], dtype=np.int64)])
    tiles = per_point.reshape(-1, tile, RAW_WORDS, 8 * N_TILES).sum(axis=1)
    flush_tiles = flush_points // tile
    cols = [[0] * COLS for _ in range(ROWS)]
    for b in range(bpg):
        mine = tiles[b::bpg]  # grid-stride: block b takes tiles b, b + bpg, ...
        for start in range(0, len(mine), flush_tiles):
            s32 = mine[start : start + flush_tiles].sum(axis=0)
            assert s32.max() < 1 << 31  # the mma's s32 sums
            for w in range(RAW_WORDS):
                for col in range(8 * N_TILES):
                    r, j = divmod(col, WIN)
                    if r < ROWS:
                        cols[r][4 * w + j] += int(s32[w, col])
                    else:
                        assert s32[w, col] == 0  # the zero columns
    assert max(max(c) for c in cols) < 1 << 64
    return cols


def _plain_value(cols: list) -> int:
    """Pass 2 of one sum: carry the columns into DEFERRED_WIDE_WORDS 32-bit
    words, three REDCs."""
    words, carry = [], 0
    for k in range(K.DEFERRED_WIDE_WORDS):
        word = 0
        for b in range(4):
            c = 4 * k + b
            x = (cols[c] if c < COLS else 0) + carry
            assert x < 1 << 64
            word |= (x & 0xFF) << (8 * b)
            carry = x >> 8
        words.append(word)
    assert carry == 0
    t = sum(w << (32 * k) for k, w in enumerate(words))
    for _ in range(3):
        assert t + (R - 1) * P < 1 << (32 * K.DEFERRED_WIDE_WORDS)
        t = _redc(t)
    assert t < 2 * P
    return t


def _coefficients(a: list, t: list) -> list:
    """c_0..c_8 in Montgomery form (lazy) from the plain values A_m, T_m:
    mul_small, sub and add mod 2p, then one REDC by R^2."""
    out = []
    for m in range(9):
        c = _mod2p(math.comb(7, m) * a[m]) if m < 8 else 0
        if m > 0:
            c = _mod2p(c + _mod2p(math.comb(7, m - 1) * _mod2p(t[m - 1] - a[m - 1])))
        out.append(_redc(c * R2))
        assert out[-1] < 2 * P
    return out


def _evaluate(coef: list, t: int) -> int:
    """Horner's rule on adds mod 2p; P(0) = c_0."""
    p = coef[8]
    for m in range(7, -1, -1):
        p = _mod2p((t * p if t else 0) + coef[m])
    return p


def direct_model(eq, x0, x1, ark, g, tile=K.DEFERRED_TILE, flush_points=K.DEFERRED_FLUSH_POINTS, bpg=1):
    """(coefficients (9, G), values at t = 0..8 (9, G)) canonical ints, by
    the kernel's arithmetic."""
    raws = _raws(x0, x1, ark, g)
    eqv = fr.limb_values(eq)
    n = len(eqv) // g
    half = n // 2
    coeffs, values = [], []
    for grp in range(g):
        e, et = eqv[grp * n : grp * n + half], eqv[grp * n + half : (grp + 1) * n]
        pts = slice(grp * half, (grp + 1) * half)
        a, t = [], []
        for m in range(8):
            raw = raws[m][pts]
            cols = _block_columns(raw, [e, et], tile, flush_points, bpg)
            for row, w in enumerate((e, et)):
                assert sum(c << (8 * i) for i, c in enumerate(cols[row])) == sum(x * y for x, y in zip(w, raw))
            a.append(_plain_value(cols[0]))
            t.append(_plain_value(cols[1]))
        coef = _coefficients(a, t)
        coeffs.append([c % P for c in coef])
        values.append([_evaluate(coef, tt) % P for tt in range(9)])
    return [list(col) for col in zip(*coeffs)], [list(col) for col in zip(*values)]


def _lazy(rng, n):
    limbs = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    limbs[7] %= 0x60C89CE5  # below the top limb of 2p
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32))


def _ints(out) -> list:
    """(8, k, G) canonical tensor -> [k][G] ints, each below p."""
    vals = [[fr.limb_values(out[:, i, grp].reshape(8, 1).contiguous())[0] for grp in range(out.shape[2])]
            for i in range(out.shape[1])]
    assert all(v < P for row in vals for v in row)
    return vals


def _check(eq, x0, x1, ark, g, **geometry):
    coeffs, values = direct_model(eq, x0, x1, ark, g, **geometry)
    assert coeffs == _ints(K.cipher_coeff_acc_plain(eq, x0, x1, ark, g))
    assert values == _ints(K.cipher_partial_evals_plain(eq, x0, x1, ark, g, 9, False))
    assert values[1:] == _ints(K.cipher_partial_evals_plain(eq, x0, x1, ark, g, 9, True))  # skip_t0


@pytest.mark.parametrize("g", [1, 2])
def test_direct_model_matches_plain(g):
    rng = np.random.default_rng(70 + g)
    n = 16
    eq, x0, x1, ark = _lazy(rng, g * n), _lazy(rng, g * n), _lazy(rng, g * n), _lazy(rng, g)
    _check(eq, x0, x1, ark, g)
    # tiles of 2 points dealt to 2 blocks, flushed every 4 points: the
    # flush path and the blocks' partials
    _check(eq, x0, x1, ark, g, tile=2, flush_points=4, bpg=2)


def test_direct_model_at_lazy_edges_and_headroom():
    """All inputs 2p - 1; eq = 2p - 1 with x0, x1 and ark over the lazy
    edges; eq over the edges too (G = 2). Then the kernel's constants: a
    flush interval of s32 digit sums, the 64-bit columns and the wide
    integer at 2^30 points with weights below 2p, and pass 1's shared
    memory for one and two weight rows."""
    n, top = 16, 2 * P - 1
    edge = fr._limb_tensor([top] * n)
    _check(edge, edge, edge, fr._limb_tensor([top]), 1)
    cyc = [LAZY_EDGES[i % len(LAZY_EDGES)] for i in range(4 * n)]
    x0, x1 = fr._limb_tensor(cyc[:n]), fr._limb_tensor(cyc[n : 2 * n][::-1])
    for a in (top, LAZY_EDGES[3]):
        _check(edge, x0, x1, fr._limb_tensor([a]), 1)
    eq2, x02, x12 = fr._limb_tensor(cyc[2 * n :]), fr._limb_tensor(cyc[: 2 * n]), fr._limb_tensor(cyc[::-1][: 2 * n])
    _check(eq2, x02, x12, fr._limb_tensor(LAZY_EDGES[3:5]), 2, tile=2, flush_points=4, bpg=3)
    # headroom of the CUDA constants
    assert K.DEFERRED_FLUSH_POINTS % K.DEFERRED_TILE == 0
    assert K.DEFERRED_FLUSH_POINTS * 4 * 255**2 < 1 << 31
    assert 4 * (RAW_WORDS - 1) + WIN <= COLS
    points = 1 << 30
    assert points * 32 * 255**2 < 1 << 64  # a byte column: at most 32 byte pairs a point
    assert points * (2 * P) * (4 * P * P) + (R - 1) * P < 1 << (32 * K.DEFERRED_WIDE_WORDS)
    stride = 4 * (K.DEFERRED_TILE + 4)  # bytes a shared row
    for rows, want in ((1, 181_120), (2, 220_800)):
        wins = 8 * -(-rows * WIN // 8)
        smem = (8 * RAW_WORDS + wins) * stride + 8 * 8 * rows * COLS
        assert smem == want and smem <= SMEM_LIMIT
