"""BN254 fr arithmetic on (8, *batch) int32 tensors of 32-bit limbs.

The plain torch field: exact, vectorised over the batch, and the same
formulas as the CUDA header ``csrc/fr.cuh``, so a kernel and its plain twin
give the same bits. Layout and representation are described in the
package docstring: limb-major 32-bit limbs (int32 bit patterns), Montgomery
form with R = 2**256, lazy representatives in [0, 2p).

* ``add`` / ``sub`` are exact arithmetic mod 2p (one conditional
  subtraction of 2p), so a sum of lazy values does not depend on the order
  of its terms.
* ``mul`` is REDC(a*b) = (a*b + m*p) / R with m = a*b*(-p^-1) mod R and no
  final subtraction: for a, b < 2p the result is < 2p. The integer m is
  unique, so this equals the word-by-word CIOS result of the CUDA header.
  Here the schoolbook and the reduction run on 16-bit digits in int64
  columns (no 64-bit overflow), one digit of m at a time.

On a CUDA tensor these functions are glue for small tensors (round
scalars, the tail rounds); every large pass of the main path is a kernel
in ``ops/kernels.py``. ``mul`` works on at most ``CHUNK`` elements at a time,
so its temporaries stay O(CHUNK) whatever the batch. CPU batches of at most
``SMALL`` elements compute the same integers on host ints instead, since
the torch path spends ~150 tiny ops on one multiply.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bn254 import NPRIME, L, P, R1, R2, RINV, int_to_limbs

I32 = torch.int32
I64 = torch.int64
_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
_P16 = [(P >> (16 * i)) & _M16 for i in range(16)]
assert _P16[0] == 1  # so -p^-1 = -1 mod 2**16 (used by _mul_exact)
_TWOP_LIMBS = int_to_limbs(2 * P)
_P_LIMBS = int_to_limbs(P)

CHUNK = 1 << 20  # largest batch one plain multiply works on at once
SMALL = 64  # CPU batches up to this size compute on host ints (same bits)
_R_MASK = (1 << 256) - 1


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------


def _limb_tensor(ints, device=None) -> torch.Tensor:
    """Python ints (each < 2**256) -> (8, n) int32 limb tensor."""
    raw = b"".join(int(x).to_bytes(32, "little") for x in ints)
    arr = np.frombuffer(raw, dtype="<u4").reshape(len(ints), L).T.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def encode_mont_ints(xs, device=None) -> torch.Tensor:
    """Canonical Montgomery limbs of ``x * R mod p``: (8, n)."""
    return _limb_tensor([(x % P) * R1 % P for x in xs], device)


def from_ints_mont(xs, device=None) -> torch.Tensor:
    return encode_mont_ints(xs, device)


def from_int_mont(x: int, device=None) -> torch.Tensor:
    return encode_mont_ints([x], device)[:, 0]


def limb_values(a: torch.Tensor) -> list[int]:
    """Integers held by a (8, *S) limb tensor (no Montgomery decode)."""
    arr = np.ascontiguousarray(a.detach().cpu().numpy().reshape(L, -1).T)
    raw = arr.view(np.uint32).astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(arr.shape[0])]


def to_ints(a: torch.Tensor) -> list[int]:
    """Montgomery limb tensor (8, *S) -> canonical ints (host decode)."""
    return [v * RINV % P for v in limb_values(a)]


def to_int(a: torch.Tensor) -> int:
    return to_ints(a)[0]


@lru_cache(maxsize=None)
def _const_limbs(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    t = torch.tensor(values, dtype=I64)
    if dtype == I32:
        t = torch.where(t >= 1 << 31, t - (1 << 32), t).to(I32)
    return t.to(device)


def _const(values, ndim: int, device, dtype=I32) -> torch.Tensor:
    """A constant limb column (len(values), 1, ...) with `ndim` total dims."""
    t = _const_limbs(tuple(values), torch.device(device), dtype)
    return t.reshape((len(values),) + (1,) * (ndim - 1))


def const_mont(x: int, batch_ndim: int = 0, device=None) -> torch.Tensor:
    return _const(int_to_limbs((x % P) * R1 % P), batch_ndim + 1, device or "cpu")


def zeros(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((L,) + tuple(batch_shape), dtype=I32, device=device)


def one(batch_shape=(), device=None) -> torch.Tensor:
    c = const_mont(1, len(tuple(batch_shape)), device)
    return c.expand((L,) + tuple(batch_shape)).contiguous()


# ---------------------------------------------------------------------------
# Limb plumbing
# ---------------------------------------------------------------------------


def _u64(a: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values in int64."""
    return a.to(I64) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def _carry32(s: torch.Tensor) -> torch.Tensor:
    """Propagate carries (or borrows) of int64 32-bit columns in place; the
    top limb keeps the excess (negative iff the value is negative)."""
    for i in range(L - 1):
        s[i + 1] += s[i] >> 32
        s[i] &= _M32
    return s


def _cond_sub(s: torch.Tensor, c_limbs) -> torch.Tensor:
    """s (exact int64 limbs, value < 2**256) minus c iff s >= c."""
    d = _carry32(s - _const(c_limbs, s.ndim, s.device, I64))
    return torch.where(d[L - 1] >= 0, d, s)


def _host_ints(f, a: torch.Tensor, b: torch.Tensor):
    """f elementwise on the held integers, for small CPU batches (the
    torch path costs ~150 tiny ops per multiply); None otherwise."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.device.type != "cpu" or int(np.prod(shape[1:], dtype=np.int64)) > SMALL:
        return None
    xs, ys = limb_values(a.expand(shape)), limb_values(b.expand(shape))
    return _limb_tensor([f(x, y) for x, y in zip(xs, ys)]).reshape(shape)


def _redc_int(x: int, y: int) -> int:
    t = x * y
    return (t + ((t * NPRIME) & _R_MASK) * P) >> 256


# ---------------------------------------------------------------------------
# Public arithmetic
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2p on lazy representatives. Broadcasts."""
    out = _host_ints(lambda x, y: (x + y) % (2 * P), a, b)
    if out is not None:
        return out
    s = _carry32(_u64(a) + _u64(b))
    return _to_i32(_cond_sub(s, _TWOP_LIMBS))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2p on lazy representatives. Broadcasts."""
    out = _host_ints(lambda x, y: (x - y) % (2 * P), a, b)
    if out is not None:
        return out
    s = _u64(a) - _u64(b)
    s = _carry32(s + _const(_TWOP_LIMBS, s.ndim, s.device, I64))
    return _to_i32(_cond_sub(s, _TWOP_LIMBS))


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Lazy representative [0, 2p) -> canonical [0, p)."""
    return _to_i32(_cond_sub(_u64(a), _P_LIMBS))


def _split16(a: torch.Tensor) -> torch.Tensor:
    """(8, *S) int32 -> (16, *S) int64 16-bit digits, little-endian."""
    x = _u64(a)
    return torch.stack([x & _M16, x >> 16], dim=1).reshape((16,) + x.shape[1:])


def product_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 512-bit product a*b as 33 redundant 16-bit columns (int64, each
    < 16 * 2**32; column 31 and 32 are 0): (33, *S)."""
    a16, b16 = _split16(a), _split16(b)
    shape = torch.broadcast_shapes(a16.shape[1:], b16.shape[1:])
    cols = torch.zeros((33,) + shape, dtype=I64, device=a.device)
    for i in range(16):
        cols[i : i + 16] += a16[i] * b16
    return cols


def redc_columns(cols: torch.Tensor) -> torch.Tensor:
    """REDC (T + m p) / R of a value T < 2**512 held in 33 redundant 16-bit
    columns (int64, updated in place), with the result below 2**256:
    (8, *S) limbs."""
    p16 = _const(_P16, cols.ndim, cols.device, I64)
    for i in range(16):  # add m_i * p * 2**(16 i), digit i of m at a time
        m = (-cols[i]) & _M16  # cols[i] * (-p^-1) mod 2**16, as p = 1 mod 2**16
        cols[i : i + 16] += m * p16
        cols[i + 1] += cols[i] >> 16  # column i is now 0 mod 2**16
    hi = cols[16:32]  # (T + m p) / R, redundant 16-bit columns
    s = hi[0::2] + (hi[1::2] << 16)
    return _to_i32(_carry32(s))


def _mul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return redc_columns(product_columns(a, b))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product REDC(a*b) on lazy representatives. Broadcasts."""
    out = _host_ints(_redc_int, a, b)
    if out is not None:
        return out
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = int(np.prod(shape[1:], dtype=np.int64))
    if n <= CHUNK:
        return _mul_exact(a, b)
    af = a.expand(shape).reshape(L, n)
    bf = b.expand(shape).reshape(L, n)
    out = torch.empty((L, n), dtype=I32, device=a.device)
    for i in range(0, n, CHUNK):
        out[:, i : i + CHUNK] = _mul_exact(af[:, i : i + CHUNK], bf[:, i : i + CHUNK])
    return out.reshape(shape)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """c * a mod 2p for a small integer c >= 1, by doubling and adding from
    the top bit of c (csrc/fr.cuh mul_small): each add is exact mod 2p, so
    the bits do not depend on the chain."""
    r = a
    for bit in bin(c)[3:]:
        r = add(r, r)
        if bit == "1":
            r = add(r, a)
    return r


def pow7(a: torch.Tensor) -> torch.Tensor:
    """x^7 as square, mul, square, mul (the reference S-box chain)."""
    x2 = square(a)
    x3 = mul(x2, a)
    x6 = square(x3)
    return mul(x6, a)


def to_mont(a_std: torch.Tensor) -> torch.Tensor:
    return mul(a_std, _const(int_to_limbs(R2), a_std.ndim, a_std.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, _const(int_to_limbs(1), a.ndim, a.device))


def reduce_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Field sum along batch axis ``axis`` (0 == tensor axis 1): a pairwise
    tree of ``add``, exact mod 2p, so the result equals any other order's."""
    x = x.movedim(axis + 1, -1)
    n = x.shape[-1]
    if n == 0:
        return zeros(x.shape[1:-1], x.device)
    while n > 1:
        half = n // 2
        s = add(x[..., :half], x[..., half : 2 * half])
        x = torch.cat([s, x[..., 2 * half :]], dim=-1) if n % 2 else s
        n = x.shape[-1]
    return x[..., 0]
