"""The port's field constants, round constants, layout conversions and
deterministic inputs against the JAX package; the port's entry points
default to the card; the port imports without JAX.

The field operations are held against the JAX package in
tests/test_torch_field_ops.py, the lazy arithmetic's two paths in
tests/test_torch_field_lazy.py (seven cases or fewer a file, as
tests/test_torch_models.py explains).

    python -m pytest tests/test_torch_field*.py -q -p no:cacheprovider
"""

import subprocess
import sys
from pathlib import Path

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
from torch_common import lazy_ints

P = bn254.P


def test_constants_and_arks_match_jax():
    assert (bn254.P, bn254.R1, bn254.R2, bn254.RINV, bn254.NPRIME) == (jbn.P, jbn.R1, jbn.R2, jbn.RINV, jbn.NPRIME)
    assert (ark_data.ARKS, ark_data.XARR, ark_data.YARR) == (jark_data.ARKS, jark_data.XARR, jark_data.YARR)
    assert (ark.ARKS_INT, ark.XARR_INT, ark.YARR_INT) == (jark.ARKS_INT, jark.XARR_INT, jark.YARR_INT)
    got = from_jax_rows(np.ascontiguousarray(jark.arks_scan_tensor(91).T))
    assert torch.equal(got, arks_mont(91).T.contiguous())


def test_layout_converters_round_trip():
    vals = lazy_ints(64, 6)
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
    from gkr_mimc_tpu_torch import gadget
    from gkr_mimc_tpu_torch.models.mimc import mimc_circuit
    from gkr_mimc_tpu_torch.parallel import mesh, multihost
    from gkr_mimc_tpu_torch.sumcheck import testing

    c = mimc_circuit()
    calls = [
        lambda: common.random_fr_device(4),
        lambda: common.grouped_inputs(1, 2)[0],
        lambda: testing.initialize_cipher_gate_instance(1)[0][0],
        lambda: testing.initialize_multi_instance(1, 2)[0][0],
        lambda: testing.to_device_qprimes([[1, 2]]),
        lambda: testing.to_device_claims([3]),
        lambda: gadget.GkrGadget(),  # its .device
        lambda: gadget.InCircuitGkrGadget(),  # its .device
        lambda: gadget.GadgetCircuit(lambda cs, g: None),  # its .device
        lambda: gadget.proof_from_vec(c, 1, [0] * gadget.proof_size(c, 1)).qprimes[-1],
        lambda: multihost.make_global_mesh(),  # its .device
        lambda: mesh.make_mesh(),  # its .device
        lambda: multihost.shard_mimc_inputs_global(multihost.make_global_mesh(), 4),
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    if not torch.cuda.is_available():  # verify_gadget and dryrun return nothing to look at
        with pytest.raises((AssertionError, RuntimeError)):
            gadget.verify_gadget(c, gadget.GadgetSetup([], [], 1, 1), gadget.GadgetProof(0, 0, (0, 1, 0), []),
                                 gadget.IoStore())
        with pytest.raises(RuntimeError):
            mesh.dryrun(2)


def test_package_imports_without_jax():
    """Every module of the port, its entry points and chip_smoke.py import
    with jax made unimportable."""
    root = Path(__file__).resolve().parent.parent
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "gkr_mimc_tpu_torch").rglob("*.py")
    )
    assert {"gkr_mimc_tpu_torch.bench", "gkr_mimc_tpu_torch.bench_pipeline"} <= set(mods)  # the entry points
    mods.append("chip_smoke")
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
