"""The port's field (gkr_mimc_tpu_torch.fields) against the JAX package.

Same integers go through gkr_mimc_tpu.fields.fr (16-bit limbs) and
gkr_mimc_tpu_torch.fields.fr (32-bit limbs); results are compared as
canonical field values, exactly. Inputs include lazy representatives up to
2p - 1. Both of the port's paths run: host ints for small CPU batches and
the torch limb arithmetic (the one the card uses) for large ones.
"""

import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.fields import bn254 as jbn
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.hashes import ark as jark
from gkr_mimc_tpu.hashes import ark_data as jark_data
from gkr_mimc_tpu.utils import common as jcommon
from gkr_mimc_tpu_torch.fields import bn254, fr
from gkr_mimc_tpu_torch.hashes import ark, ark_data
from gkr_mimc_tpu_torch.hashes.ark import arks_mont
from gkr_mimc_tpu_torch.utils import common
from gkr_mimc_tpu_torch.utils.convert import from_jax_rows, ints_to_rows, rows_to_ints, to_jax_rows

P = bn254.P
EDGE = [0, 1, 2, P - 2, P - 1, P, P + 1, 2 * P - 2, 2 * P - 1, (1 << 255) % P, 0xFFFFFFFF]


def _lazy_ints(n, seed):
    rng = random.Random(seed)
    vals = EDGE + [rng.randrange(2 * P) for _ in range(n - len(EDGE))]
    return vals[:n]


def _both(vals):
    """The same held integers in both layouts: (port (8, n), JAX (16, n))."""
    t = fr._limb_tensor(vals)
    return t, jnp.asarray(to_jax_rows(t))


@pytest.fixture(scope="module")
def operands():
    return _both(_lazy_ints(160, 1)), _both(_lazy_ints(160, 2)[::-1])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "pow7", "to_mont", "from_mont", "canonicalize"])
def test_ops_match_jax(operands, op):
    """160 elements take the torch limb path, the first 40 the host-int
    path; both equal the JAX package's values."""
    (a, ja), (b, jb) = operands
    assert 40 <= fr.SMALL < 160
    f, jf = getattr(fr, op), jax.jit(getattr(jfr, op))
    if op in ("add", "sub", "mul"):
        want, full, small = jf(ja, jb), f(a, b), f(a[:, :40], b[:, :40])
    else:
        want, full, small = jf(ja), f(a), f(a[:, :40])
    want = jfr.to_ints(want)
    assert fr.to_ints(full) == want
    assert fr.to_ints(small) == want[:40]


def test_ops_stay_lazy_and_agree_across_paths():
    """Both paths give the same bits (not only values), all below 2p."""
    a, _ = _both(_lazy_ints(100, 3))
    b, _ = _both(_lazy_ints(100, 4))
    small = [(fr.mul(a[:, i : i + 1], b[:, i : i + 1]), fr.add(a[:, i : i + 1], b[:, i : i + 1])) for i in range(100)]
    big_mul, big_add = fr.mul(a, b), fr.add(a, b)
    assert torch.equal(torch.cat([m for m, _ in small], 1), big_mul)
    assert torch.equal(torch.cat([s for _, s in small], 1), big_add)
    assert max(fr.limb_values(big_mul)) < 2 * P
    assert fr.limb_values(fr.canonicalize(big_mul)) == [v % P for v in fr.limb_values(big_mul)]


@pytest.mark.parametrize("c", [1, 7, 21, 35])
def test_mul_small_is_the_held_multiple_mod_2p(c):
    """c * a by doubling and adding: the held integer c * a mod 2p, the
    same bits on the host-int and the torch limb paths (the binomial
    scaling of cipher_coeff_acc)."""
    vals = _lazy_ints(100, 6)
    a = fr._limb_tensor(vals)
    want = [c * v % (2 * P) for v in vals]
    assert fr.limb_values(fr.mul_small(a, c)) == want
    assert fr.limb_values(fr.mul_small(a[:, :40], c)) == want[:40]


def test_reduce_sum_matches_host_sums():
    vals = _lazy_ints(3 * 37, 5)
    t = fr._limb_tensor(vals).reshape(8, 3, 37)
    got = fr.to_ints(fr.reduce_sum(t, 1))
    assert got == [sum(vals[37 * i : 37 * i + 37]) * bn254.RINV % P for i in range(3)]


def test_constants_and_arks_match_jax():
    assert (bn254.P, bn254.R1, bn254.R2, bn254.RINV, bn254.NPRIME) == (jbn.P, jbn.R1, jbn.R2, jbn.RINV, jbn.NPRIME)
    assert (ark_data.ARKS, ark_data.XARR, ark_data.YARR) == (jark_data.ARKS, jark_data.XARR, jark_data.YARR)
    assert (ark.ARKS_INT, ark.XARR_INT, ark.YARR_INT) == (jark.ARKS_INT, jark.XARR_INT, jark.YARR_INT)
    got = from_jax_rows(np.ascontiguousarray(jark.arks_scan_tensor(91).T))
    assert torch.equal(got, arks_mont(91).T.contiguous())


def test_layout_converters_round_trip():
    vals = _lazy_ints(64, 6)
    t = fr._limb_tensor(vals).reshape(8, 4, 16)
    j = to_jax_rows(t)
    assert j.shape == (16, 4, 16) and j.max() < 1 << 16
    assert torch.equal(from_jax_rows(j), t)
    assert jfr.decode_ints(j) == vals
    ints = [[x % P for x in vals[:8]], [x % P for x in vals[8:16]]]
    rows = ints_to_rows(ints)
    assert rows.shape == (2, 8, 8) and rows_to_ints(rows) == ints
    assert torch.equal(from_jax_rows(jfr.encode_mont_ints(vals[:8])), fr.encode_mont_ints(vals[:8]))


def test_random_inputs_match_jax():
    assert common.random_fr_array(50) == jcommon.random_fr_array(50)
    for size, offset in [(64, 0), (40, (1 << 32) - 40), (33, 70000)]:
        got = common.random_fr_device(size, offset, device="cpu")
        want = jcommon.random_fr_device(size, offset)
        assert torch.equal(got, from_jax_rows(np.asarray(want)))


def test_entry_points_default_to_the_card():
    """Naming no device puts the tensors on the card; with no card the
    call raises (no fallback to the CPU)."""
    from gkr_mimc_tpu_torch.sumcheck import testing

    calls = [
        lambda: common.random_fr_device(4),
        lambda: common.grouped_inputs(1, 2)[0],
        lambda: testing.initialize_cipher_gate_instance(1)[0][0],
        lambda: testing.initialize_multi_instance(1, 2)[0][0],
        lambda: testing.to_device_qprimes([[1, 2]]),
        lambda: testing.to_device_claims([3]),
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_package_imports_without_jax():
    """Every module of the port imports with jax made unimportable."""
    root = Path(__file__).resolve().parent.parent
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "gkr_mimc_tpu_torch").rglob("*.py")
    )
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "assert not any(k == 'gkr_mimc_tpu' or k.startswith(('gkr_mimc_tpu.', 'jax')) for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")
