"""Layout conversions: the reference's (16, ...) 16-bit-limb tables <->
the port's (8, ...) 32-bit-limb tables, and limb-last rows <-> host ints.

Small proof artifacts (round coefficients, challenges, claims, evaluation
points) are rows with the limb axis LAST, ``(..., 8)``; tables are
limb-major ``(8, ...)``. All conversions are host work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import fr
from ..fields.bn254 import L, P, RINV


def from_jax_rows(arr: np.ndarray) -> torch.Tensor:
    """Reference layout uint32 (16, ...) of 16-bit limbs -> (8, ...) int32
    of 32-bit limbs holding the same integers."""
    a = np.asarray(arr, dtype=np.uint32)
    if a.shape[0] != 16 or (a >> 16).any():
        raise ValueError("expected (16, ...) limbs below 2**16")
    out = a[0::2] | (a[1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int32))


def to_jax_rows(t: torch.Tensor) -> np.ndarray:
    """(8, ...) int32 32-bit limbs -> reference layout uint32 (16, ...)."""
    a = t.detach().cpu().numpy().view(np.uint32)
    out = np.empty((16,) + a.shape[1:], dtype=np.uint32)
    out[0::2] = a & np.uint32(0xFFFF)
    out[1::2] = a >> np.uint32(16)
    return out


def rows_to_ints(t: torch.Tensor):
    """Montgomery rows with the limb axis last (..., 8) -> nested int lists."""
    a = np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)
    if a.shape[-1] != L:
        raise ValueError(f"expected limb axis last, got shape {a.shape}")
    flat = a.reshape(-1, L)
    raw = flat.astype("<u4").tobytes()
    ints = [int.from_bytes(raw[32 * i : 32 * i + 32], "little") * RINV % P for i in range(flat.shape[0])]
    return _nest(ints, a.shape[:-1])


def _nest(flat, shape):
    if not shape:
        return flat[0]
    step = len(flat) // shape[0] if shape[0] else 0
    return [_nest(flat[i * step : (i + 1) * step], shape[1:]) for i in range(shape[0])]


def ints_to_rows(values, device=None) -> torch.Tensor:
    """Nested int lists -> canonical Montgomery rows (..., 8) int32."""

    def shape_of(v):
        if isinstance(v, int):
            return ()
        return (len(v),) + (shape_of(v[0]) if len(v) else ())

    def flatten(v):
        if isinstance(v, int):
            return [v]
        return [x for e in v for x in flatten(e)]

    shape = shape_of(values)
    flat = flatten(values)
    if not flat:
        return torch.zeros(shape + (L,), dtype=torch.int32, device=device)
    return fr.encode_mont_ints(flat, device).T.reshape(shape + (L,)).contiguous()
