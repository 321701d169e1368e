"""Both direct head-round paths reproduce the golden transcript of the
multi-instance sumcheck (10 claims at bn = 3), and the single-claim eq
table takes its two builds (doubling through mul_scalar below 2**13
entries, the hi/lo contraction from there).

The reference picks among the same three paths with its GKR_GRUEN and
GKR_COEFF_PE switches, and every one emits the same transcript: each
computes the same round polynomials exactly. Small tail_bits put the
rounds on the kernel paths; on the CPU every kernel wrapper takes its
plain twin. No JAX program runs here: the goldens and the "gruen" path are
already held against the JAX package (tests/test_torch_sumcheck*.py,
tests/test_torch_gkr*.py).

    python -m pytest tests/test_torch_rounds_multi.py -q -p no:cacheprovider
"""

import pytest

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.poly import multilin
from gkr_mimc_tpu_torch.sumcheck import prover
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows
from torch_common import sumcheck_golden


@pytest.mark.parametrize("tail_bits", [2, 0])
@pytest.mark.parametrize("case", ["multi_bn3_j10"])
@pytest.mark.parametrize("rounds", ["coeff", "evals"])
def test_sumcheck_golden(rounds, case, tail_bits):
    """tail_bits 0 runs every round, down to a table of 2 entries, on the
    path"s head rounds."""
    got, want = sumcheck_golden(rounds, case, tail_bits)
    assert got == want


@pytest.mark.parametrize("bn, mul_scalar, multi_eq", [(12, 3, 0), (13, 0, 1)])
def test_single_claim_eq_table(monkeypatch, bn, mul_scalar, multi_eq):
    """One claim: below 2**13 entries the doubling build, whose steps on
    tables of at least 512 entries multiply through K.mul_scalar; from
    2**13 the hi/lo contraction with multiplier one and no RLC hash. Both
    give eq_table's values."""
    calls = {"mul_scalar": 0, "multi_eq": 0, "mimc_hash": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(K, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(K, name, counted)
    qprimes = ints_to_rows([random_fr_array(bn)])  # (1, bn, 8)
    got = prover._make_eq(qprimes, fr.zeros((1,)), prover.LO_BITS)
    assert calls == {"mul_scalar": mul_scalar, "multi_eq": multi_eq, "mimc_hash": 0}
    monkeypatch.undo()
    assert fr.to_ints(got) == fr.to_ints(multilin.eq_table(qprimes[0]))
