"""Models of the two redesigned probes on the CPU: cipher_pe_variant's
per-t kernel (csrc/partial_evals.cu: the walk over t, the integer sums and
the finish that takes them mod 2p once) and field_check's "f64" variant (the
FP64 product of csrc/f64m.cuh, into R' = 2^260 and back), step by step on
Python ints, held bit for bit to their plain versions; and both wrappers on
CPU tensors. No JAX program: the plain versions are held to JAX in
tests/test_torch_probes.py. The kernels themselves run only on a card
(chip_smoke.py phase 9, tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import pytest
import torch
from test_torch_probes_hopper import f64_entry, f64_exit, f64_mul, f64_square

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import NPRIME, P
from gkr_mimc_tpu_torch.ops import probes as Pr

SRC = (Path(Pr.__file__).resolve().parent.parent / "csrc" / "partial_evals.cu").read_text()
R = 1 << 256
TWO_P = 2 * P
WORDS = 9  # an integer sum: eight 32-bit words and a carry word
EVALS = 9


# ---------------------------------------------------------------------------
# cipher_pe_variant: the kernel's arithmetic on Python ints
# ---------------------------------------------------------------------------


def _add(a: int, b: int) -> int:
    """fr::add: exact mod 2p on inputs below 2p."""
    assert 0 <= a < TWO_P and 0 <= b < TWO_P
    s = a + b
    return s - TWO_P if s >= TWO_P else s


def _sub(a: int, b: int) -> int:
    assert 0 <= a < TWO_P and 0 <= b < TWO_P
    d = a - b
    return d + TWO_P if d < 0 else d


def _redc(a: int, b: int) -> int:
    """REDC(a b), the integer fr::mul, fr::mul_ptx and fr::square return."""
    t = a * b
    r = (t + (t * NPRIME % R) * P) >> 256
    assert r < TWO_P
    return r


def _term(e: int, x: int) -> int:
    """e x^7: x^2 and x^6 by fr::square, x^3, x^7 and e by fr::mul_ptx."""
    x3 = _redc(_redc(x, x), x)
    return _redc(e, _redc(_redc(x3, x3), x))


def _finish(words: list) -> int:
    """pe_finish_kernel: nine 64-bit word sums -> the sum's residue below
    2p, mod p by one REDC of the top word, then the parity."""
    v, c = [], 0
    for w in words:
        assert 0 <= w < 1 << 64
        s = w + c
        assert s < 1 << 64  # the kernel adds in 64 bits
        v.append(s & 0xFFFFFFFF)
        c = s >> 32
    assert c == 0  # the sum is below 2^288
    lo = sum(x << (32 * k) for k, x in enumerate(v[:8]))
    assert lo < 3 * TWO_P  # two conditional subtractions of 2p suffice
    for _ in range(2):
        lo = lo - TWO_P if lo >= TWO_P else lo
    r2 = R * R % P
    assert _parse_words("PE_R2") == r2
    r = _add(lo, _redc(v[8], r2))
    r = r - P if r >= P else r
    return r + P if (r ^ v[0]) & 1 else r


def _parse_words(name: str) -> int:
    body = re.search(rf"#define {name} \{{([^}}]*)\}}", SRC).group(1)
    return sum(int(w.strip().rstrip("u"), 16) << (32 * k) for k, w in enumerate(body.split(",")))


def pe_model(eq, x0, x1, ark, warp_points: int = 32) -> list:
    """The kernel on Python ints: each point walks t = 0..8 from the bottom
    of its tables by adds; each warp's points (``warp_points`` at a time,
    in any grouping: integer sums do not depend on it) sum to one integer
    below 2^288 a t, whose words go into 64-bit word sums; the finish takes
    each t's sum mod 2p. -> [t] as the (8, 9, 1) output holds them."""
    E, U, W = (fr.limb_values(t) for t in (eq, x0, x1))
    a = fr.limb_values(ark)[0]
    half = len(E) // 2
    words = [[0] * WORDS for _ in range(EVALS)]
    for start in range(0, half, warp_points):
        warp = [0] * EVALS
        for y in range(start, min(start + warp_points, half)):
            eb, et = E[y], E[y + half]
            sb, st = _add(_add(W[y], a), U[y]), _add(_add(W[y + half], a), U[y + half])
            de, ds = _sub(et, eb), _sub(st, sb)
            e, s = eb, sb
            for t in range(EVALS):
                warp[t] += _term(e, s)
                e, s = _add(e, de), _add(s, ds)
        for t in range(EVALS):
            assert warp[t] < 1 << (32 * WORDS)
            for k in range(WORDS):
                words[t][k] += warp[t] >> (32 * k) & 0xFFFFFFFF
    return [_finish(w) for w in words]


def _plain_values(eq, x0, x1, ark) -> list:
    out = Pr.cipher_pe_variant_plain(eq, x0, x1, ark)
    assert out.shape == (8, EVALS, 1)
    return fr.limb_values(out[:, :, 0].contiguous())


def _edge_tables(n: int):
    """eq, x0, x1 of n entries built from the lazy edges (and 0, p - 1,
    2p - 1), each table a different rotation so that bottom and top pair
    different edges; ark 2p - 1."""
    edges = Pr.LAZY_EDGES + [0, P - 1, 2 * P - 1]
    tables = [fr._limb_tensor([edges[(k * i + 3 * k) % len(edges)] for i in range(n)]) for k in (1, 2, 5)]
    return (*tables, fr._limb_tensor([2 * P - 1]))


def test_pe_model_equals_plain_on_seeded_points():
    """2^12 seeded points (half = 2^11), two warp groupings: the plain
    version's lazy sums, bit for bit."""
    eq, x0, x1 = (Pr.lazy_table(1 << 12, s, "cpu") for s in (1, 2, 3))
    ark = fr.encode_mont_ints([145646], "cpu")
    want = _plain_values(eq, x0, x1, ark)
    assert pe_model(eq, x0, x1, ark) == want
    assert pe_model(eq, x0, x1, ark, warp_points=7) == want


def test_pe_model_equals_plain_on_lazy_edges():
    """Tables of the lazy edges (2p - 1 included) and all-(2p - 1) tables,
    where the integer sums are largest."""
    for tables in (_edge_tables(64), tuple(fr._limb_tensor([2 * P - 1] * n) for n in (256, 256, 256, 1))):
        assert pe_model(*tables) == _plain_values(*tables)


def test_pe_walk_keeps_the_tables_at_t0_and_t1():
    """The walk e_t = e_(t-1) + (e_top - e_bot) mod 2p from e_0 = e_bot
    gives e_1 = e_top exactly at every pair of lazy edges, 2p - 1 included,
    and e_t = (e_bot + t (e_top - e_bot)) mod 2p at every t up to 8."""
    edges = Pr.LAZY_EDGES + [0, P - 1, 2 * P - 1]
    for eb in edges:
        for et in edges:
            d, walk = _sub(et, eb), [eb]
            for _ in range(EVALS - 1):
                walk.append(_add(walk[-1], d))
            assert walk[1] == et
            assert walk == [(eb + t * (et - eb)) % TWO_P for t in range(EVALS)]


def test_pe_sum_headroom_at_every_size():
    """At half = 2^25 (tables of 2^26 entries, twice the largest the
    checkpointed path proves) and 2^32 - 1 (the largest the C entry takes,
    beyond any table the card holds): a t's sum of half terms below 2p
    stays below 2^288 (nine words); with at least a point a thread, the
    grid has at most half / 32 warps and a ragged block, so each 64-bit
    word sum (warps x 2^32) and the finish's carries stay below 2^64; the
    top word times R^2 mod p keeps REDC below 2p; the largest sum comes out
    of the finish as itself mod 2p."""
    assert re.search(r"half >= \(1ll << 32\)", SRC)
    for half in (1 << 25, (1 << 32) - 1):
        most = half * (TWO_P - 1)
        assert most < 1 << (32 * WORDS)
        warps = half // 32 + 512 // 32
        assert warps * 0xFFFFFFFF + (1 << 33) < 1 << 64
        top = most >> 256
        assert top < 1 << 32 and _redc(top, R * R % P) < TWO_P
        assert _finish([most >> (32 * k) & 0xFFFFFFFF for k in range(WORDS)]) == most % TWO_P


# ---------------------------------------------------------------------------
# field_check "f64": the FP64 product into R' and back
# ---------------------------------------------------------------------------


def test_f64_field_check_model_equals_fr():
    """check_mxu_mul.py's 256 inputs and edges: entry into R' = 2^260, a b,
    a^2 (the square), x^7 (mul, mul, mul, mul, as the kernel's chain), exit
    canonical: fr.canonicalize of fr.mul, fr.square and fr.pow7."""
    av, bv = Pr.field_check_ints()
    a, b = fr._limb_tensor(av), fr._limb_tensor(bv)
    want = [fr.limb_values(o) for o in Pr.field_check_plain(a, b, "f64")]
    assert want == [fr.limb_values(fr.canonicalize(o)) for o in (fr.mul(a, b), fr.square(a), fr.pow7(a))]
    got = [[], [], []]
    for x, y in zip(av, bv):
        ex, ey = f64_entry(x), f64_entry(y)
        x3 = f64_mul(f64_mul(ex, ex), ex)
        got[0].append(f64_exit(f64_mul(ex, ey)))
        got[1].append(f64_exit(f64_square(ex)))
        got[2].append(f64_exit(f64_mul(f64_mul(x3, x3), ex)))
    assert got == want


def test_wrappers_take_their_plain_versions_on_cpu():
    """field_check (every variant, "f64" canonical) and cipher_pe_variant
    (every block size) on CPU tensors return their plain versions' values;
    an unknown variant or block size raises."""
    av, bv = Pr.field_check_ints()
    a, b = fr._limb_tensor(av[:32]), fr._limb_tensor(bv[:32])
    for variant in Pr.FIELD_VARIANTS:
        got = Pr.field_check(a, b, variant)
        assert all(torch.equal(g, w) for g, w in zip(got, Pr.field_check_plain(a, b, variant)))
        assert Pr.field_check_values(av[:32], bv[:32], got) == 0
    assert all(v < P for o in Pr.field_check(a, b, "f64") for v in fr.limb_values(o))
    with pytest.raises(ValueError):
        Pr.field_check(a, b, "f32")
    eq, x0, x1 = (Pr.lazy_table(64, s, "cpu") for s in (4, 5, 6))
    ark = fr.encode_mont_ints([7], "cpu")
    want = Pr.cipher_pe_variant_plain(eq, x0, x1, ark)
    for threads in Pr.PE_THREADS:
        assert torch.equal(Pr.cipher_pe_variant(eq, x0, x1, ark, threads), want)
    assert fr.limb_values(want[:, :, 0].contiguous()) == pe_model(eq, x0, x1, ark)
    with pytest.raises(ValueError):
        Pr.cipher_pe_variant(eq, x0, x1, ark, threads=1024)
    assert Pr.PE_RESULTS == 2 * 208 + 3 * 264
