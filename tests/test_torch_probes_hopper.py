"""Models of the redesigned probe kernels of csrc/probes.cu, on the CPU:
sbox_chain's product (radix 2^52 on the FP64 units, csrc/f64m.cuh; both
layouts) step by
step on Python ints, held bit for bit to the port's fr.mul on the lazy edges
and 256 seeded values below 2p; the shared-memory layout and descriptors of
imma_dot's wgmma, byte by byte; and the two wrappers, which take their plain
versions on CPU tensors. No JAX program: the plain versions are held to JAX
in tests/test_torch_probes.py. The kernels themselves run only on a card
(chip_smoke.py phase 9, tests/test_torch_cuda.py)."""

import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import P, RINV
from gkr_mimc_tpu_torch.ops import probes as Pr

CSRC = Path(Pr.__file__).resolve().parent.parent / "csrc"
SRC = (CSRC / "probes.cu").read_text()
F64M_SRC = (CSRC / "f64m.cuh").read_text()
M64 = (1 << 64) - 1


def _values():
    """The lazy edges and 256 seeded values below 2p."""
    rng = np.random.default_rng(13)
    rand = [int.from_bytes(rng.bytes(32), "little") % (2 * P) for _ in range(256)]
    return Pr.LAZY_EDGES + [P - 1, 2 * P - 1] + rand


def _fr_mul(a: list, b: list) -> list:
    """The port's fr.mul on the CPU: the REDC integers of the kernels' products."""
    return fr.limb_values(fr.mul(fr._limb_tensor(a), fr._limb_tensor(b)))


def _cuda_constants(name: str) -> list:
    body = re.search(rf"#define {name} \{{([^}}]*)\}}", F64M_SRC).group(1)
    return [int(v.strip().rstrip("ul"), 16) for v in body.split(",")]


# ---------------------------------------------------------------------------
# "col": Montgomery in radix 2^52 on the FP64 units (namespace f64m)
# ---------------------------------------------------------------------------

N52, R52, M52 = 5, 1 << 52, (1 << 52) - 1
NP52 = -pow(P, -1, R52) % R52
TWO104 = 1 << 104


def _rz(v: int) -> int:
    """An integer rounded toward zero to a double (53 significant bits)."""
    a = abs(v)
    if a.bit_length() <= 53:
        return v
    e = a.bit_length() - 53
    return (a >> e << e) * (1 if v >= 0 else -1)


def _bits(v: int) -> int:
    """The IEEE pattern of an integer a double holds exactly."""
    assert _rz(v) == v
    return struct.unpack("<Q", struct.pack("<d", float(v)))[0]


B52, B104 = _bits(R52), _bits(TWO104)


def _split(a: int, b: int) -> tuple:
    """f64m::split_into: (pattern of l, pattern of h) of a b, a, b < 2^52."""
    assert 0 <= a < R52 and 0 <= b < R52
    h = _rz(a * b + TWO104)  # __fma_rz(a, b, 2^104)
    assert TWO104 <= h < 2 * TWO104 and (h - TWO104) % R52 == 0  # one binade, ulp 2^52
    s = _rz((TWO104 + R52) - h)  # __dsub_rz(2^104 + 2^52, h): exact
    assert s == R52 - (h - TWO104)
    l = _rz(a * b + s)  # __fma_rz(a, b, s)
    assert R52 <= l < 2 * R52 and l == R52 + a * b % R52  # one binade, ulp 1: exact
    assert (h - TWO104) // R52 == a * b >> 52
    return _bits(l), _bits(h)


def _from_u52(x: int) -> int:
    """f64m::from_u52: the pattern 2^52 | x as a double, less 2^52."""
    assert 0 <= x < R52
    return struct.unpack("<d", struct.pack("<Q", x | B52))[0] - R52


def _col_offset(k, prod, sym, diag, red) -> int:
    lo = hi = 0
    for i in range(N52):
        for j in range(N52):
            take = prod and ((i == j if diag else i < j) if sym else True)
            take_red = red and j >= 1
            lo += (take and i + j == k) + (take_red and i + j == k)
            hi += (take and i + j + 1 == k) + (take_red and i + j + 1 == k)
    return -(lo * B52 + hi * B104) & M64


def _f64_reduce(col: list) -> list:
    p = [P >> (52 * k) & M52 for k in range(N52)]
    carry = 0
    for i in range(N52):
        c = (col[i] + carry) & M64
        assert c < 1 << 58  # the column is exact: every pattern's offset is taken off
        x = c & M52
        q = int(_from_u52((x * NP52) & M64 & M52))  # the 64-bit integer multiply, low 52 bits
        assert q == x * NP52 % R52
        h0 = _rz(q * p[0] + TWO104)
        carry = (c >> 52) + (_bits(h0) - B104) + (x != 0)
        assert (c + q * p[0]) % R52 == 0 and carry == (c + q * p[0]) >> 52
        for j in range(1, N52):
            lo, hi = _split(q, p[j])
            col[i + j] = (col[i + j] + lo) & M64
            col[i + j + 1] = (col[i + j + 1] + hi) & M64
    out = []
    for k in range(N52):
        t = (col[N52 + k] + carry) & M64
        assert t < 1 << 60
        out.append(t & M52 if k < N52 - 1 else t)
        carry = t >> 52
    assert out[-1] < R52  # every limb fits a double's 52-bit window again
    return out


def f64_mul(a: list, b: list) -> list:
    """f64m::mul on five 52-bit limbs: REDC with R' = 2^260."""
    col = [_col_offset(k, True, False, False, True) for k in range(2 * N52)]
    for i in range(N52):
        for j in range(N52):
            lo, hi = _split(a[i], b[j])
            col[i + j] = (col[i + j] + lo) & M64
            col[i + j + 1] = (col[i + j + 1] + hi) & M64
    return _f64_reduce(col)


def f64_square(a: list) -> list:
    """f64m::square: the cross products once, doubled, then the squares."""
    col = [_col_offset(k, True, True, False, False) for k in range(2 * N52)]
    for i in range(N52):
        for j in range(i + 1, N52):
            lo, hi = _split(a[i], a[j])
            col[i + j] = (col[i + j] + lo) & M64
            col[i + j + 1] = (col[i + j + 1] + hi) & M64
    col = [((c << 1) + _col_offset(k, True, True, True, True)) & M64 for k, c in enumerate(col)]
    for i in range(N52):
        lo, hi = _split(a[i], a[i])
        col[2 * i] = (col[2 * i] + lo) & M64
        col[2 * i + 1] = (col[2 * i + 1] + hi) & M64
    return _f64_reduce(col)


def _limbs52(v: int) -> list:
    assert v < 1 << 260
    return [v >> (52 * k) & M52 for k in range(N52)]


def _value52(limbs: list) -> int:
    return sum(x << (52 * k) for k, x in enumerate(limbs))


def f64_entry(a: int) -> list:
    return f64_mul(_limbs52(a), _limbs52((1 << 264) % P))


def f64_exit(v: list) -> int:
    r = _value52(f64_mul(v, _limbs52((1 << 256) % P)))
    assert r < 2 * P
    return r - P if r >= P else r


def test_f64_constants_are_the_models():
    """The kernel's radix-2^52 constants (p, -p^-1, the entry and exit
    multipliers, the patterns of 2^52 and 2^104) are the model's."""
    assert _cuda_constants("F64M_P") == _limbs52(P)
    assert _cuda_constants("F64M_TO_R260") == _limbs52((1 << 264) % P)
    assert _cuda_constants("F64M_TO_R256") == _limbs52((1 << 256) % P)
    assert int(re.search(r"kNp = (0x[0-9a-f]+)ull", F64M_SRC).group(1), 16) == NP52
    assert int(re.search(r"kBits52 = (0x[0-9a-f]+)ull", F64M_SRC).group(1), 16) == B52
    assert int(re.search(r"kBits104 = (0x[0-9a-f]+)ull", F64M_SRC).group(1), 16) == B104


def test_f64_product_model_equals_fr_mul():
    """Entry, product, exit: fr.mul's integer made canonical, on the lazy
    edges and 256 seeded values below 2p; each result below 2p in five
    limbs below 2^52; a b and b a the same integers."""
    vals = _values()
    others = vals[1:] + vals[:1]
    for a, b, w in zip(vals, others, [v % P for v in _fr_mul(vals, others)]):
        ea, eb = f64_entry(a), f64_entry(b)
        assert _value52(ea) < 2 * P and _value52(ea) % P == a * (1 << 4) % P
        assert f64_exit(f64_mul(ea, eb)) == w
        assert f64_mul(eb, ea) == f64_mul(ea, eb)  # the pair's exchange relies on it


def test_f64_square_model_equals_fr_mul():
    """The square (cross products once, doubled, then the squares): fr.mul's
    a a made canonical, and the product's own a a, on the same values."""
    vals = _values()
    for a, w in zip(vals, [v % P for v in _fr_mul(vals, vals)]):
        ea = f64_entry(a)
        assert f64_exit(f64_square(ea)) == w == f64_exit(f64_mul(ea, ea))


def test_f64_sbox_chains_equal_the_plain_version():
    """f64m::chain, four deep ("col") and three deep ("row", whose pair of
    threads computes the same integers), two rounds on the lazy edges: the
    plain version's canonical bits."""
    vals = Pr.LAZY_EDGES
    want = fr.limb_values(Pr.sbox_chain_plain(fr._limb_tensor(vals), "col", 2))
    for three_deep in (False, True):
        got = []
        for a in vals:
            v = f64_entry(a)
            for _ in range(2):
                x2 = f64_square(v)
                v = f64_mul(f64_mul(x2, v), f64_square(x2)) if three_deep else f64_mul(f64_square(f64_mul(x2, v)), v)
            got.append(f64_exit(v))
        assert got == want


# ---------------------------------------------------------------------------
# imma_dot: the wgmma operands in shared memory
# ---------------------------------------------------------------------------


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _smem_offset(r: int, c: int) -> int:
    """imma::smem_offset: K-major, no swizzle."""
    return (r >> 3) * _const("kSbo") + (c >> 4) * _const("kLbo") + (r & 7) * 16 + (c & 15)


def _byte_perm(x: int, y: int, s: int) -> int:
    src = x | (y << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _operand_byte(desc: int, base: int, r: int, c: int) -> int:
    """Where wgmma reads byte (row r, k byte c) of a K-major, unswizzled
    operand from its descriptor: core matrix (r / 8, c / 16) at start +
    (r / 8) SBO + (c / 16) LBO, rows 16 bytes apart inside it."""
    start, lbo, sbo = (desc & 0x3FFF) << 4, (desc >> 16 & 0x3FFF) << 4, (desc >> 32 & 0x3FFF) << 4
    assert desc >> 62 == 0 and desc >> 49 & 7 == 0  # no swizzle, base offset 0
    assert start == base
    return start + (r >> 3) * sbo + (c >> 4) * lbo + (r & 7) * 16 + (c & 15)


def _descriptor(base: int) -> int:
    """imma::descriptor of a shared-memory operand at ``base``."""
    return (base >> 4) | (_const("kLbo") >> 4) << 16 | (_const("kSbo") >> 4) << 32


def test_wgmma_a_operand_layout():
    """A's copy (thread j moves row j / 2, k half j % 2, 16 bytes) puts every
    byte of m at the one place the descriptor reads it from, and no two
    bytes at one place."""
    assert _const("kLbo") == 128 and _const("kSbo") == 256
    base = 0x400
    m = np.random.default_rng(7).integers(-128, 128, size=(64, 32)).astype(np.int8).view(np.uint8)
    smem = {}
    for j in range(128):
        r, h = j >> 1, j & 1
        for i in range(16):
            off = base + _smem_offset(r, 16 * h) + i
            assert off not in smem
            smem[off] = int(m[r, 16 * h + i])
    assert len(smem) == 64 * 32
    assert all(smem[_operand_byte(_descriptor(base), base, r, c)] == m[r, c] for r in range(64) for c in range(32))


def test_wgmma_x_tile_rewrite_covers_every_byte_once():
    """The x tile's K-major rewrite (the kernel's 32-bit loads, __byte_perm
    transposes and 16-byte stores, thread by thread) puts every byte of a
    32 x 256 tile at the one place the descriptor reads it from, and no
    two bytes at one place; the tile's ragged edge is zero."""
    kn, base = _const("kN"), 0x1000
    assert kn == 256
    n = 200  # one ragged tile: columns 200..255 are past n
    x = np.random.default_rng(8).integers(-128, 128, size=(32, n)).astype(np.int8).view(np.uint8)
    tile = {}
    for t in range(128):  # thread t reads columns 4g..4g+3 of rows 16h..16h+15
        g, h = t & 63, t >> 6
        col = 4 * g
        v = [int.from_bytes(bytes(x[16 * h + i, col:col + 4]), "little") if col < n else 0 for i in range(16)]
        cw = [[0] * 4 for _ in range(4)]
        for blk in range(4):
            r = v[4 * blk:4 * blk + 4]
            t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
            t2, t3 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
            cols = [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                    _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
            for c in range(4):
                cw[c][blk] = cols[c]
        for c in range(4):
            word16 = b"".join(w.to_bytes(4, "little") for w in cw[c])
            for i in range(16):
                off = base + _smem_offset(4 * g + c, 16 * h) + i
                assert off not in tile
                tile[off] = word16[i]
    assert len(tile) == kn * 32
    for col in range(kn):
        for k in range(32):
            want = int(x[k, col]) if col < n else 0
            assert tile[_operand_byte(_descriptor(base), base, col, k)] == want


# ---------------------------------------------------------------------------
# The wrappers on CPU tensors
# ---------------------------------------------------------------------------


def test_wrappers_take_their_plain_versions_on_cpu():
    """imma_dot and sbox_chain (both layouts) on CPU tensors return their
    plain versions' values; the argument checks hold."""
    m, x = Pr.imma_inputs(64, "cpu")
    got = Pr.imma_dot(m, x, 5)
    assert torch.equal(got, Pr.imma_dot_plain(m, x, 5))
    assert torch.equal(got, (torch.from_numpy(m.numpy().astype(np.int64) @ x.numpy().astype(np.int64)) * 5)
                       .to(torch.int32))
    lo = torch.full((64, 32), -128, dtype=torch.int8)
    xl = torch.full((32, 8), -128, dtype=torch.int8)
    assert int(Pr.imma_dot(lo, xl, Pr.IMMA_MAX_REPS).max()) == Pr.IMMA_MAX_REPS * 32 * 128 * 128 < 1 << 31
    with pytest.raises(ValueError):
        Pr.imma_dot(m, x, 1, threads=96)
    vals = Pr.LAZY_EDGES[:6]
    t = fr._limb_tensor(vals)
    want = [pow(v * RINV % P, 7 ** 3, P) for v in vals]
    for layout in Pr.LAYOUTS:
        got = fr.limb_values(Pr.sbox_chain(t, layout, 3))
        assert [v * RINV % P for v in got] == want and all(v < P for v in got)
    with pytest.raises(ValueError):
        Pr.sbox_chain(t, "diagonal", 3)
