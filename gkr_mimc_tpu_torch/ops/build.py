"""Build the CUDA kernels of ``csrc/`` into one shared library at first use
and load it with ctypes.

The library has a plain C interface (no PyTorch headers). Each source is
compiled by its own ``nvcc`` process, all started together, and the objects
are then linked into one library; the build takes as long as the slowest
source. It goes to ``_build/`` beside the package (listed in
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
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry points: argument types (each returns a cudaError_t as int)
SIGNATURES = {
    "gkr_witness": (_P, _P, _P, _P, _I, _I, _P),
    "gkr_mimc_hash": (_P, _P, _P, _I, _I, _P),
    "gkr_fold": (_P, _P, _I, _P, _I, _I, _P),
    "gkr_suffix_step": (_P, _P, _P, _I, _I, _P),
    "gkr_multi_eq": (_P, _P, _P, _I, _I, _I, _P),
    "gkr_gruen_acc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gkr_identity_acc": (_P, _P, _P, _P, _I, _I, _I, _P),
    "gkr_gruen_round": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "gkr_cipher_coeff_acc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gkr_cipher_partial_evals": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gkr_identity_partial_evals": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gkr_mul_scalar": (_P, _P, _P, _I, _P),
    "gkr_pow7": (_P, _P, _I, _P),
    "gkr_cipher_layer": (_P, _P, _P, _P, _I, _P),
    "gkr_tail_rounds": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # probes (ops/probes.py)
    "gkr_cipher_partial_evals_ptx": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gkr_probe_op_chain": (_P, _P, _P, _I, _I, _I, _I, _P),
    "gkr_probe_imma_dot": (_P, _P, _P, _I, _I, _I, _P),
    "gkr_probe_field_check": (_P, _P, _P, _P, _P, _I, _I, _P),
    "gkr_probe_mul_chain": (_P, _P, _P, _I, _I, _I, _I, _P),
    "gkr_probe_sbox_chain": (_P, _P, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    stem = f"{out.stem}.{os.getpid()}"
    jobs = []  # (source, object, log, process)
    try:
        for src in sources():
            obj = BUILD_DIR / f"{stem}.{src.stem}.o"
            log = BUILD_DIR / f"{stem}.{src.stem}.log"
            with open(log, "w") as fh:
                cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                jobs.append((src, obj, log, subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)))
        failed = [src.name for src, _, _, proc in jobs if proc.wait() != 0]
        report = "".join(f"== {src.name}\n{log.read_text()}" for src, _, log, _ in jobs)
        if not failed:
            tmp = out.with_name(f"{stem}.tmp")
            res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for _, o, _, _ in jobs)],
                                 capture_output=True, text=True)
            report += f"== link\n{res.stdout}{res.stderr}"
            if res.returncode != 0:
                failed = ["link"]
        Path(f"{out}.log").write_text(report)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{report[-4000:]}")
        os.replace(tmp, out)
    finally:
        for _, obj, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
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
