"""In-circuit polynomials (the counterpart of gkr_mimc_tpu/snark/polynomial.py).

MultiLin: a table of variables with fold and eval; an eval costs O(2^bN)
constraints, the verifier's largest in-circuit cost. Univariate: Horner
eval and p(0) + p(1). Eq: the product form.
"""

from __future__ import annotations

from .cs import ConstraintSystem, Variable


class MultiLin(list):
    """Evaluations over the hypercube, variable 0 the most significant bit."""

    @classmethod
    def from_ints(cls, cs: ConstraintSystem, values: list[int]) -> "MultiLin":
        return cls(cs.witness(v) for v in values)

    def fold(self, cs: ConstraintSystem, x: Variable) -> None:
        k = len(self) // 2
        for i in range(k):
            tmp = cs.sub(self[i + k], self[i])
            self[i] = cs.add(self[i], cs.mul(tmp, x))
        del self[k:]

    def eval(self, cs: ConstraintSystem, xs: list[Variable]) -> Variable:
        f = MultiLin(self)
        for x in xs:
            f.fold(cs, x)
        return f[0]


class Univariate(list):
    """Coefficient form a0..ad."""

    @classmethod
    def from_ints(cls, cs: ConstraintSystem, coeffs: list[int]) -> "Univariate":
        return cls(cs.witness(c) for c in coeffs)

    def eval(self, cs: ConstraintSystem, x: Variable) -> Variable:
        res = cs.constant(0)
        aux = cs.constant(0)
        for i in range(len(self) - 1, -1, -1):
            if i != len(self) - 1:
                res = cs.mul(aux, x)
            aux = cs.add(res, self[i])
        return aux

    def zero_and_one(self, cs: ConstraintSystem) -> Variable:
        """p(0) + p(1) = 2 a0 + a1 + ... + ad, as one add."""
        return cs.add(self[0], self[0], *self[1:])


def univariate_eq_eval(cs: ConstraintSystem, q, h) -> Variable:
    """1 - q - h + 2qh."""
    res = cs.sub(cs.constant(1), q)
    res = cs.sub(res, h)
    return cs.add(res, cs.mul(cs.constant(2), cs.mul(q, h)))


def eq_eval(cs: ConstraintSystem, qprime: list, hprime: list) -> Variable:
    """Eq(q', h') as the product of the univariate factors."""
    res = cs.constant(1)
    for q, h in zip(qprime, hprime):
        res = cs.mul(res, univariate_eq_eval(cs, q, h))
    return res
