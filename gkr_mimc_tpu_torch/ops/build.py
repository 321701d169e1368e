"""Build the CUDA kernels of ``csrc/`` into one shared library at first use
and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds. It goes to ``_build/`` beside the package (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags; a
changed source builds anew, an unchanged one loads the existing file.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory and spills per
kernel) is kept beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry points: argument types (each returns a cudaError_t as int)
SIGNATURES = {
    "gkr_witness": (_P, _P, _P, _P, _I, _I, _P),
    "gkr_mimc_hash": (_P, _P, _P, _I, _I, _P),
    "gkr_fold": (_P, _P, _I, _P, _I, _I, _P),
    "gkr_suffix_step": (_P, _P, _P, _I, _I, _P),
    "gkr_multi_eq": (_P, _P, _P, _I, _I, _I, _P),
    "gkr_gruen_acc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gkr_identity_acc": (_P, _P, _P, _P, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    return BUILD_DIR / f"libgkr_kernels_{source_digest()}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    Path(f"{out}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.gkr_error_string.argtypes = [ctypes.c_int]
    lib.gkr_error_string.restype = ctypes.c_char_p
    return lib
