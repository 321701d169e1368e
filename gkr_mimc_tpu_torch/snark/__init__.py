"""The in-circuit GKR verifier, the counterpart of gkr_mimc_tpu/snark/.

The reference's snark packages re-express the GKR verifier over gnark
circuit variables, so that a GKR proof is checked inside a Groth16 SNARK.
Here the same verification relation runs over an eager constraint tracer:
``cs.ConstraintSystem`` checks every assert on concrete values and counts
R1CS constraints; ``r1cs.RecordingCS`` also records the constraints and the
solution, for the Groth16 tier (``gadget.groth16``, ``gadget.incircuit``).
All of it is host Python on ints.
"""

from .cs import ConstraintSystem, UnsatisfiedConstraint, Variable
from .gkr import Proof
from .hash import mimc_hash
from .polynomial import MultiLin, Univariate, eq_eval, univariate_eq_eval
from .sumcheck import SumcheckProof

__all__ = [
    "ConstraintSystem",
    "MultiLin",
    "Proof",
    "SumcheckProof",
    "Univariate",
    "UnsatisfiedConstraint",
    "Variable",
    "eq_eval",
    "mimc_hash",
    "univariate_eq_eval",
]
