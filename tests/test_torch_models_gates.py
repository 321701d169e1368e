"""The port's gates (gkr_mimc_tpu_torch.circuits.gates) against the JAX
package's, and the two S-box kernels' plain twins against the JAX functions
the Pallas kernels compute.

Every gate's eval_batch runs on (8, 3, 5) batches (strided views among
them) and is compared, exactly on canonical values, with the JAX gate's
eval_batch, all seven JAX gates in one compiled program; eval_scalar is
held against the JAX host oracle. The cipher and S-box gates evaluate
through the ``cipher_layer`` and ``pow7`` wrappers, which take their plain
twins on the CPU; their cases also call the wrappers and the twins
directly on (8, N) tables. tests/test_torch_cuda.py holds the kernels
against the twins on the card. Seven cases, as tests/test_torch_models.py
explains.

    python -m pytest tests/test_torch_models_gates.py -q -p no:cacheprovider
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu_torch.circuits import gates
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L, P
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.utils.convert import to_jax_rows

TWO_P_TOP = 0x60C89CE5  # top 32-bit limb of 2p


def rand_lazy(rng, *shape):
    """(8, *shape) field elements below 2p from a numpy generator."""
    limbs = rng.integers(0, 1 << 32, size=(L,) + shape, dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32))


_C = [0x2B5D3F1A9E7C4B8D, 3, P - 5, 12345678901234567890123456789]  # gate constants, some above 2**64
GATES = [  # (port gate, JAX gate): every gate of the GMiMC and Poseidon circuits, and the rest of the zoo
    (gates.CipherGate(_C[0]), jgates.CipherGate(_C[0])),
    (gates.SBoxGate(), jgates.SBoxGate()),
    (gates.AddGate(), jgates.AddGate()),
    (gates.MulGate(), jgates.MulGate()),
    (gates.AffineGate(*_C[1:4]), jgates.AffineGate(*_C[1:4])),
    (gates.LinearGate(_C[:3]), jgates.LinearGate(_C[:3])),
    (gates.LinearGate(_C[1:4], _C[0]), jgates.LinearGate(_C[1:4], _C[0])),
]


@pytest.fixture(scope="module")
def gate_case():
    """Three lazy (8, 3, 5) operands (the first two as strided views) and
    every JAX gate's eval_batch on them, in one JAX program."""
    rng = np.random.default_rng(16)
    xs = [rand_lazy(rng, 5, 3).transpose(1, 2) for _ in range(2)] + [rand_lazy(rng, 3, 5)]

    @jax.jit
    def jax_gates(jxs):
        return [jg.eval_batch(jg.params(), jxs[: jg.arity]) for _, jg in GATES]

    return xs, [jfr.to_ints(w) for w in jax_gates([jnp.asarray(to_jax_rows(x.contiguous())) for x in xs])]


@pytest.mark.parametrize("i", range(len(GATES)), ids=[f"{g.name}{i}" for i, (g, _) in enumerate(GATES)])
def test_gate_matches_jax(gate_case, i):
    """eval_batch against the JAX gate's, eval_scalar against the JAX
    gate's host oracle and the batch; for the cipher and S-box gates also
    the cipher_layer and pow7 wrappers and their plain twins (JAX
    CipherGate.eval_batch and fr.pow7, the portable form of the Pallas
    kernels cipher_layer and pow7) on the operands as (8, 15) tables."""
    xs, want = gate_case
    gate, jgate = GATES[i]
    got = gate.eval_batch(gate.params(), xs[: gate.arity])
    assert got.shape == (L, 3, 5) and (gate.degree, gate.arity) == (jgate.degree, jgate.arity)
    assert fr.to_ints(got.contiguous()) == want[i]
    ints = [fr.to_ints(x.contiguous()) for x in xs[: gate.arity]]
    for k in (0, 7, 14):
        cols = [v[k] for v in ints]
        assert gate.eval_scalar(cols) == jgate.eval_scalar(cols) == want[i][k]
    tables = [x.reshape(L, 15).contiguous() for x in xs[: gate.arity]]
    if isinstance(gate, gates.CipherGate):
        ark = fr.from_int_mont(_C[0])
        outs = [K.cipher_layer(*tables, ark), K.cipher_layer_plain(*tables, ark)]
    elif isinstance(gate, gates.SBoxGate):
        outs = [K.pow7(*tables), K.pow7_plain(*tables)]
    else:
        outs = []
    for out in outs:
        assert out.shape == (L, 15) and fr.to_ints(out) == want[i]
