"""The identity rounds' deferred-reduction algorithm (csrc/round_acc.cu,
namespace deferred: identity_acc_kernel and identity_finish_kernel) as a
Python-int model, held equal to the plain twins ``identity_acc_plain`` and
``identity_partial_evals_plain``.

The CUDA kernel cannot run here. This model follows its arithmetic step by
step: the 16 rows of the contraction's A operand (the 8 words of x[bot],
then of x[top], as they lie in the table); the 35 byte windows of
eb = eq[bot] and of et = eq[top], packed into 9 tiles of 8 columns (window
column 35 r + j, two zero columns); the per-point digit sums of the
tensor-core contraction (byte 4 w + q of a word row times byte j - q of a
window); tiles of IDENTITY_TILE points, each split among IDENTITY_WARPS
warps (contiguous runs of points); each warp's s32 sums, flushed every
IDENTITY_FLUSH_POINTS // IDENTITY_TILE tiles of its block (tiles dealt out
grid-stride) into the warp's byte columns 4 g + j of sum 2 h + r; the
warps' and blocks' columns added; the carry into one integer of
DEFERRED_WIDE_WORDS words; two REDCs to the plain values A = <eb, xb>,
C = <et, xb>, B = <eb, xt>, D = <et, xt>; the coefficients A, B + C - 2A,
A - B - C + D by the finisher's adds mod 2p and one REDC by R^2; and the
values at t by Horner's rule, canonical. It checks each headroom the kernel
relies on as it goes.

    python -m pytest tests/test_torch_identity_deferred.py -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import NPRIME, P, R2
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.ops.probes import LAZY_EDGES

R = 1 << 256
WIN, COLS, SUMS = K.DEFERRED_WINDOWS, K.IDENTITY_COLS, 4
N_TILES = -(-2 * WIN // 8)  # 9 tiles of 8 window columns
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on the H100
SM_SMEM = 233_472  # shared memory of an SM, of which each resident block also takes 1,024 B


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


def _windows(weights: list) -> np.ndarray:
    """(points, 8 * N_TILES, 4): byte q of window column 35 r + j is byte
    j - q of eq half r, zero outside 0..31; the last columns zero."""
    win = np.zeros((len(weights[0]), 8 * N_TILES, 4), dtype=np.int64)
    for r, vals in enumerate(weights):
        wb = _bytes(vals, 32)
        for j in range(WIN):
            for q in range(4):
                if 0 <= j - q < 32:
                    win[:, WIN * r + j, q] = wb[:, j - q]
    return win


def _group_columns(xb, xt, eb, et, tile, warps, flush_tiles, bpg) -> list:
    """Pass 1 over one group: the byte columns [sum 2 h + r][4 g + j], the
    warps' and the blocks' added; each warp's s32 digit sums checked below
    2^31 at every flush."""
    rows = np.concatenate([_bytes(xb, 32).reshape(-1, 8, 4), _bytes(xt, 32).reshape(-1, 8, 4)], axis=1)
    per_point = np.einsum("pwq,pcq->pwc", rows, _windows([eb, et]))  # (points, 16, 72)
    assert per_point.max() <= 4 * 255**2
    pad = -len(xb) % tile  # the last tile: zero words past the end
    per_point = np.concatenate([per_point, np.zeros((pad,) + per_point.shape[1:], dtype=np.int64)])
    # (tiles, warps, 16, 72): warp k sums the tile's k-th run of tile / warps points
    tiles = per_point.reshape(-1, warps, tile // warps, 16, 8 * N_TILES).sum(axis=2)
    cols = [[0] * COLS for _ in range(SUMS)]
    for b in range(bpg):
        mine = tiles[b::bpg]  # grid-stride: block b takes tiles b, b + bpg, ...
        for start in range(0, len(mine), flush_tiles):
            for warp in range(warps):
                s32 = mine[start : start + flush_tiles, warp].sum(axis=0)
                assert s32.max() < 1 << 31  # the mma's s32 sums
                for row in range(16):
                    h, g = divmod(row, 8)
                    for col in range(8 * N_TILES):
                        r, j = divmod(col, WIN)
                        if r < 2:
                            cols[2 * h + r][4 * g + j] += int(s32[row, col])
                        else:
                            assert s32[row, col] == 0  # the zero columns
    assert max(max(c) for c in cols) < 1 << 64
    return cols


def _plain_value(cols: list) -> int:
    """Pass 2 of one sum: carry the columns into DEFERRED_WIDE_WORDS 32-bit
    words, two REDCs."""
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
    for _ in range(2):
        assert t + (R - 1) * P < 1 << (32 * K.DEFERRED_WIDE_WORDS)
        t = _redc(t)
    assert t < 2 * P
    return t


def identity_model(eq, x, g, tile=K.IDENTITY_TILE, warps=K.IDENTITY_WARPS,
                   flush_tiles=K.IDENTITY_FLUSH_POINTS // K.IDENTITY_TILE, bpg=1):
    """(coefficients (3, G), values at t = 0..2 (3, G)) canonical ints, by
    the kernel's arithmetic."""
    eqv, xv = fr.limb_values(eq), fr.limb_values(x)
    n = len(eqv) // g
    half = n // 2
    coeffs, values = [], []
    for grp in range(g):
        eb, et = eqv[grp * n : grp * n + half], eqv[grp * n + half : (grp + 1) * n]
        xb, xt = xv[grp * n : grp * n + half], xv[grp * n + half : (grp + 1) * n]
        cols = _group_columns(xb, xt, eb, et, tile, warps, flush_tiles, bpg)
        for s, (w, u) in enumerate(((eb, xb), (et, xb), (eb, xt), (et, xt))):
            assert sum(c << (8 * i) for i, c in enumerate(cols[s])) == sum(a * b for a, b in zip(w, u))
        a, c, b, d = (_plain_value(col) for col in cols)
        bc = _mod2p(b + c)
        coef = [_redc(k * R2) for k in (a, _mod2p(bc - _mod2p(a + a)), _mod2p(_mod2p(a - bc) + d))]
        assert max(coef) < 2 * P
        at_t = []
        for t in range(3):
            p = coef[2]
            for m in (1, 0):
                p = _mod2p((t * p if t else 0) + coef[m])
            at_t.append(p % P)
        coeffs.append([k % P for k in coef])
        values.append(at_t)
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


def _check(eq, x, g, **geometry):
    coeffs, values = identity_model(eq, x, g, **geometry)
    assert coeffs == _ints(K.identity_acc_plain(eq, x, g))
    assert values == _ints(K.identity_partial_evals_plain(eq, x, g, 3, False))
    assert values[1:] == _ints(K.identity_partial_evals_plain(eq, x, g, 3, True))  # skip_t0


@pytest.mark.parametrize("g", [1, 2])
def test_identity_model_matches_plain(g):
    """Ragged halves at the kernel's geometry (1 point, and 64 points of a
    128-point tile), then tiles of 4 points split between 2 warps, flushed
    every 2 tiles and dealt to 3 blocks: the flushes, the warps' and the
    blocks' partials, and tiles that the blocks do not divide."""
    rng = np.random.default_rng(90 + g)
    for n in (2, 128):
        _check(_lazy(rng, g * n), _lazy(rng, g * n), g)
    _check(_lazy(rng, g * 64), _lazy(rng, g * 64), g, tile=4, warps=2, flush_tiles=2, bpg=3)


def test_identity_model_at_lazy_edges_and_headroom():
    """eq = x = 2p - 1; eq = 2p - 1 against x over the lazy edges; both over
    the edges (G = 2, small geometry). Then the kernel's constants: a warp's
    s32 digit sums over a flush interval, the byte columns, the wide integer
    and the two REDCs for a group of 2^24 entries at 2p - 1, and pass 1's
    shared memory at three blocks an SM."""
    n, top = 16, 2 * P - 1
    edge = fr._limb_tensor([top] * n)
    _check(edge, edge, 1)
    cyc = [LAZY_EDGES[i % len(LAZY_EDGES)] for i in range(4 * n)]
    _check(edge, fr._limb_tensor(cyc[:n]), 1)
    _check(fr._limb_tensor(cyc[2 * n :]), fr._limb_tensor(cyc[: 2 * n][::-1]), 2, tile=4, warps=2, flush_tiles=2,
           bpg=3)
    # headroom of the CUDA constants
    assert K.IDENTITY_FLUSH_POINTS % K.IDENTITY_TILE == 0 and K.IDENTITY_TILE % (8 * K.IDENTITY_WARPS) == 0
    assert K.IDENTITY_FLUSH_POINTS // K.IDENTITY_WARPS * 4 * 255**2 < 1 << 31
    assert 4 * 7 + WIN - 1 < COLS
    points = 1 << 23  # half of a group of 2^24 entries
    assert points * 32 * 255**2 < 1 << 64  # a byte column: at most 32 byte pairs a point
    t = points * top * top
    assert t + (R - 1) * P < 1 << (32 * K.DEFERRED_WIDE_WORDS)
    for _ in range(2):
        t = (t + (R - 1) * P) >> 256  # the largest REDC result
    assert t < 2 * P
    stride = 4 * (K.IDENTITY_TILE + 4)  # bytes a shared row
    smem = (2 * 16 + 8 * N_TILES) * stride + 8 * K.IDENTITY_WARPS * SUMS * COLS
    assert smem == 63_104 and smem <= SMEM_LIMIT
    assert K.IDENTITY_BLOCKS_PER_SM * (smem + 1024) <= SM_SMEM
