"""The port's CUDA kernels against their plain torch twins, bit for bit.

These tests need a CUDA device and skip elsewhere (the kernels have no CPU
mode). The file imports neither jax nor gkr_mimc_tpu, so it also runs on a
machine without JAX; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L
from gkr_mimc_tpu_torch.hashes.ark import arks_mont
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.ops import probes as Pr

TWO_P_TOP = 0x60C89CE5  # top 32-bit limb of 2p


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _cases(rng, dev):
    """Per kernel: argument tuples at the smallest sizes, ragged blocks
    and several groups."""

    def r(*shape):
        limbs = rng.integers(0, 1 << 32, size=(L,) + shape, dtype=np.uint64)
        limbs[L - 1] %= TWO_P_TOP
        return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)

    arks = arks_mont(91, dev)
    two_p = 2 * Pr.LAZY_EDGES[5]  # LAZY_EDGES[5] is p
    top = fr._limb_tensor([two_p - 1] * 32, dev)
    cyc = fr._limb_tensor([Pr.LAZY_EDGES[i % len(Pr.LAZY_EDGES)] for i in range(64)], dev)
    direct_edges = [(top, top, top, top[:, :1].contiguous(), 1),
                    (top, cyc[:, :32].contiguous(), cyc[:, 32:].contiguous(), top[:, :1].contiguous(), 1),
                    (cyc, cyc.flip(1).contiguous(), cyc, cyc[:, 3:5].contiguous(), 2)]
    return {
        "mimc_witness": [(r(1), r(1), arks), (r(300), r(300), arks)],
        "mimc_hash": [(r(1),), (r(9),), (r(130),)],
        "mimc_hash_g": [(r(9, 1),), (r(3, 70),)],
        "fold": [([r(2)], r(1)), ([r(3 * 64), r(3 * 64)], r(3)), ([r(600 * 4)] * 4, r(600)),
                 ([r(4 * 1024) for _ in range(3)], r(4))],
        "suffix_step": [(r(1), r(1)), (r(3 * 32), r(3)), (r(1 << 12), r(1))],
        "multi_eq": [(r(1, 1).permute(1, 0, 2).contiguous(), r(1, 2)),
                     (r(5, 91).permute(1, 0, 2).contiguous(), r(91, 64)),
                     (r(8, 1).permute(1, 0, 2).contiguous(), r(1, 1024))],
        "mul_scalar": [(r(1), r(1)[:, 0].contiguous()), (r(700), r(1)[:, 0].contiguous())],
        # ragged tiles, G = 1, 2, 3, 4, the lazy edges (all 2p - 1; S = 2p - 1 over cycled edges)
        # and G = 4 x 2^20, where a block sums more points than one flush interval
        "gruen_acc": [(r(1), r(2), r(2), r(1)), (r(3 * 512), r(3 * 1024), r(3 * 1024), r(3)),
                      (r(1 << 15), r(1 << 16), r(1 << 16), r(1)), (r(2 * 64), r(2 * 128), r(2 * 128), r(2)),
                      (top[:, :16].contiguous(), top, top, top[:, :1].contiguous()),
                      (top, cyc, cyc.flip(1).contiguous(), top[:, :1].contiguous()),
                      (top[:, :16].contiguous(), cyc[:, :32].contiguous(), cyc[:, 32:].contiguous(),
                       cyc[:, 3:5].contiguous()),
                      (r(4 << 19), r(4 << 20), r(4 << 20), r(4))],
        # the direct rounds share gruen_acc's pass 1: the same edges (eq = 2p - 1, or cycled
        # over the edges at G = 2) and the flush-interval case
        "cipher_coeff_acc": [(r(2), r(2), r(2), r(1), 1), (r(3 * 1024), r(3 * 1024), r(3 * 1024), r(3), 3),
                             (r(1 << 16), r(1 << 16), r(1 << 16), r(1), 1)] + direct_edges
                            + [(r(4 << 20), r(4 << 20), r(4 << 20), r(4), 4)],
        "identity_acc": [(r(2), r(2), 1), (r(3 * 1024), r(3 * 1024), 3), (r(1 << 16), r(1 << 16), 1)],
        "cipher_partial_evals": [(r(2), r(2), r(2), r(1), 1, 9, False), (r(4 * 512), r(4 * 512), r(4 * 512), r(4), 4, 9, True),
                                 (r(1 << 16), r(1 << 16), r(1 << 16), r(1), 1, 9, True)]
                                + [e + (9, skip) for e in direct_edges for skip in (False, True)]
                                + [(r(4 << 20), r(4 << 20), r(4 << 20), r(4), 4, 9, True)],
        "identity_partial_evals": [(r(2), r(2), 1, 3, True), (r(4 * 512), r(4 * 512), 4, 3, False),
                                   (r(1 << 16), r(1 << 16), 1, 3, True)],
        "pow7": [(r(1),), (r(300),), (r(1 << 16),)],
        "cipher_layer": [(r(1), r(1), r(1)[:, 0].contiguous()), (r(300), r(300), r(1)[:, 0].contiguous()),
                         (r(1 << 16), r(1 << 16), r(1)[:, 0].contiguous())],
        "gruen_round_scalar": [(r(8, 1), r(1), r(1), r(1), r(1)), (r(8, 3), r(3), r(3), r(3), r(3)),
                               (r(8, 70), r(70), r(70), r(70), r(70))],
        # both gates at G = 1 and 4, the main path's tail (m = 2^8) and a single round (m = 2)
        "tail_rounds": [(r(g, m), [r(g, m) for _ in range(k)], r(1)[:, 0].contiguous() if k == 2 else None)
                        for k in (2, 1) for g in (1, 4) for m in (1 << 8, 2)],
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_matches_plain_twin(cuda_device, name):
    for args in _cases(np.random.default_rng(7), cuda_device)[name]:
        before = K.LAUNCHES[name]
        got = getattr(K, name)(*args)
        want = K.PLAIN[name](*args)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 1
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The probes (ops/probes.py) against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(Pr.PROBES))
def test_probe_matches_plain(cuda_device, name):
    for args in Pr.small_cases(cuda_device)[name]:
        before = Pr.PROBE_LAUNCHES[name]
        got = getattr(Pr, name)(*args)
        assert Pr.PROBE_LAUNCHES[name] == before + 1
        Pr.check(name, got, Pr.PLAIN[name](*args))  # bit-equal; the f32 body (fused on the card) to 1e-5


@pytest.mark.gpu
def test_mul_ptx_and_square_equal_mul_on_edges(cuda_device):
    """fr::mul_ptx, fr::mul_fips, fr::square and fr::square_fips give
    fr::mul's integers on every pair of lazy-range edge values; the mul_ptx
    partial evals (per t, lazy) equal the production kernel's (deferred,
    canonical) once canonical."""
    edges = Pr.LAZY_EDGES
    a = fr._limb_tensor([x for x in edges for _ in edges], cuda_device)
    b = fr._limb_tensor([y for _ in edges for y in edges], cuda_device)
    std = Pr.field_check(a, b, "mul")
    sq_std = Pr.field_check(a, a, "mul")
    assert torch.equal(sq_std[0], sq_std[1])
    for variant in ("mul_ptx", "mul_fips"):
        assert all(torch.equal(s, p) for s, p in zip(std, Pr.field_check(a, b, variant)))
        assert torch.equal(Pr.field_check(a, a, variant)[1], sq_std[1])
    eq, x0, x1 = (Pr.lazy_table(1 << 12, s, cuda_device) for s in (1, 2, 3))
    ark = fr.encode_mont_ints([145646], cuda_device)
    v1 = K.cipher_partial_evals(eq, x0, x1, ark, 1, 9, False)
    for threads in Pr.PE_THREADS:
        assert torch.equal(fr.canonicalize(Pr.cipher_pe_variant(eq, x0, x1, ark, threads)), v1)
