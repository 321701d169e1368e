"""The gadget's host runtime: the repository's ``native/bn254.cpp`` (BN254
G1 and G2 group laws, Pippenger MSMs, fixed-base batch scalar
multiplication, Keccak-256 and Groth16's computeH NTT) bound with ctypes,
the counterpart of ``gkr_mimc_tpu/native/__init__.py``.

The library is built with ``g++`` at first use into ``_build/`` beside
the package (listed in ``.gitignore``), under a name keyed by a hash of
the source and the flags; an unchanged source loads the existing file.
Unlike the reference, whose loader returns None when the build fails and
lets its callers run pure Python, ``library()`` raises ``NativeBuildError``
with g++'s output. The pure-Python group laws, Keccak and computeH
(``gadget/bn254_g1.py``, ``bn254_g2.py``, ``keccak.py``, the ``*_plain``
functions of ``groth16.py``) are reached only by name.

ABI (``native/bn254.cpp``): a coordinate or a scalar is four uint64 limbs,
little-endian, in plain (not Montgomery) form; a G1 point is Jacobian
(X, Y, Z), twelve limbs, Z == 0 for the identity; a G2 point is Jacobian
over Fp2, each coordinate (c0, c1), 24 limbs. All eight entries are bound;
``gkr_g1_add`` and ``gkr_g2_add`` have no wrapper (the tests call them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..fields.bn254 import P as R  # the scalar field of G1 is fr

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE.parent / "native" / "bn254.cpp"
BUILD_DIR = PACKAGE / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeBuildError(RuntimeError):
    """The host runtime could not be built or loaded."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgkrbn254_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/bn254.cpp`` unless the library for this source
    exists. Concurrent builders each write their own file and rename it
    into place."""
    if not SOURCE.exists():
        raise NativeBuildError(f"{SOURCE} not found")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded host runtime (built on first call)."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"loading {path}: {e}") from e
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, argtypes in {
        "gkr_g1_msm": [u64p, u64p, ctypes.c_uint64, u64p],
        "gkr_g1_batch_scalar_mul": [u64p, u64p, ctypes.c_uint64, u64p],
        "gkr_keccak256": [u8p, ctypes.c_uint64, u8p],
        "gkr_g1_add": [u64p, u64p, u64p],
        "gkr_g2_msm": [u64p, u64p, ctypes.c_uint64, u64p],
        "gkr_g2_batch_scalar_mul": [u64p, u64p, ctypes.c_uint64, u64p],
        "gkr_g2_add": [u64p, u64p, u64p],
        "gkr_fr_compute_h": [u64p, u64p, u64p, ctypes.c_uint64, ctypes.c_uint64, u64p],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        library()
    except NativeBuildError:
        return False
    return True


# -- packing (bytes-based: int.to_bytes over one buffer) ----------------------


def _pack_points(points: list) -> np.ndarray:
    raw = b"".join(
        x.to_bytes(32, "little") + y.to_bytes(32, "little") + z.to_bytes(32, "little") for (x, y, z) in points
    )
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(points), 12).copy()


def _pack_scalars(scalars: list[int]) -> np.ndarray:
    raw = b"".join((s % R).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(scalars), 4).copy()


def _unpack_points(buf: np.ndarray) -> list:
    """(n, 12) uint64 Jacobian points -> [(x, y, z)] ints."""
    raw = buf.tobytes()
    return [
        (
            int.from_bytes(raw[o : o + 32], "little"),
            int.from_bytes(raw[o + 32 : o + 64], "little"),
            int.from_bytes(raw[o + 64 : o + 96], "little"),
        )
        for o in range(0, len(raw), 96)
    ]


def _pack_points_g2(points: list) -> np.ndarray:
    raw = b"".join(
        c.to_bytes(32, "little") for (x, y, z) in points for c in (*x, *y, *z)
    )
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(points), 24).copy()


def _unpack_points_g2(buf: np.ndarray) -> list:
    """(n, 24) uint64 Jacobian G2 points -> [((x0, x1), (y0, y1), (z0, z1))]."""
    raw = buf.tobytes()
    out = []
    for o in range(0, len(raw), 192):
        c = [int.from_bytes(raw[o + 32 * k : o + 32 * (k + 1)], "little") for k in range(6)]
        out.append(((c[0], c[1]), (c[2], c[3]), (c[4], c[5])))
    return out


def _unpack_scalars(buf: np.ndarray) -> list[int]:
    raw = buf.tobytes()
    return [int.from_bytes(raw[o : o + 32], "little") for o in range(0, len(raw), 32)]


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# -- the bound entries --------------------------------------------------------


def msm(points: list, scalars: list[int]) -> tuple:
    """sum_i scalars[i] * points[i]; Jacobian int tuples in and out,
    scalars reduced mod r here."""
    if len(points) != len(scalars):
        raise ValueError(f"msm: {len(points)} points, {len(scalars)} scalars")
    lib = library()
    pts, sc = _pack_points(points), _pack_scalars(scalars)
    out = np.zeros((1, 12), dtype=np.uint64)
    lib.gkr_g1_msm(_u64p(pts), _u64p(sc), len(points), _u64p(out))
    return _unpack_points(out)[0]


def batch_scalar_mul(base: tuple, scalars: list[int]) -> list:
    """[s * base for s in scalars] with one shared fixed-base window table."""
    lib = library()
    bp, sc = _pack_points([base]), _pack_scalars(scalars)
    out = np.zeros((len(scalars), 12), dtype=np.uint64)
    lib.gkr_g1_batch_scalar_mul(_u64p(bp), _u64p(sc), len(scalars), _u64p(out))
    return _unpack_points(out)


def keccak256(data: bytes) -> bytes:
    """Ethereum-style (legacy padding) Keccak-256 digest."""
    lib = library()
    buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\x00")
    out = (ctypes.c_uint8 * 32)()
    lib.gkr_keccak256(buf, len(data), out)
    return bytes(out)


def msm_g2(points: list, scalars: list[int]) -> tuple:
    """sum_i scalars[i] * points[i] over G2 (Jacobian Fp2 tuples)."""
    if len(points) != len(scalars):
        raise ValueError(f"msm_g2: {len(points)} points, {len(scalars)} scalars")
    lib = library()
    pts, sc = _pack_points_g2(points), _pack_scalars(scalars)
    out = np.zeros((1, 24), dtype=np.uint64)
    lib.gkr_g2_msm(_u64p(pts), _u64p(sc), len(points), _u64p(out))
    return _unpack_points_g2(out)[0]


def batch_scalar_mul_g2(base: tuple, scalars: list[int]) -> list:
    """[s * base for s in scalars] over G2, one shared fixed-base table."""
    lib = library()
    bp, sc = _pack_points_g2([base]), _pack_scalars(scalars)
    out = np.zeros((len(scalars), 24), dtype=np.uint64)
    lib.gkr_g2_batch_scalar_mul(_u64p(bp), _u64p(sc), len(scalars), _u64p(out))
    return _unpack_points_g2(out)


def compute_h(a: list[int], b: list[int], c: list[int], d: int) -> list[int]:
    """Groth16's quotient h(X) = (A(X) B(X) - C(X)) / (X^d - 1) as d
    coefficients. a, b, c are the per-constraint values, A, B, C their
    interpolants over the d-th roots of unity (d a power of two >=
    len(a)); the division runs on the coset 5 * omega^i, exact (top
    coefficient 0) when a * b = c at every constraint."""
    if not len(a) == len(b) == len(c) <= d or d & (d - 1):
        raise ValueError(f"compute_h: {len(a)}, {len(b)}, {len(c)} values, domain {d}")
    lib = library()
    pa, pb, pc = _pack_scalars(a), _pack_scalars(b), _pack_scalars(c)
    out = np.zeros((d, 4), dtype=np.uint64)
    lib.gkr_fr_compute_h(_u64p(pa), _u64p(pb), _u64p(pc), len(a), d, _u64p(out))
    return _unpack_scalars(out)
