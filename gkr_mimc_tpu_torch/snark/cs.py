"""Eager constraint-system tracer, the stand-in for gnark's frontend API
(the counterpart of gkr_mimc_tpu/snark/cs.py).

It keeps what the snark layer is for:

  1. the verification relation: every assert the circuit would enforce is
     evaluated on concrete field values (gnark's ``test.IsSolved``);
  2. the cost model: R1CS constraints, one per product of two variables
     and one per assertion, linear ops free.

Variables carry (value, is_constant); arithmetic on constants only folds
and costs nothing, as in gnark.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import scalar


class UnsatisfiedConstraint(Exception):
    pass


@dataclass(frozen=True)
class Variable:
    value: int
    is_constant: bool = False


class ConstraintSystem:
    def __init__(self):
        self.nb_multiplications = 0
        self.nb_assertions = 0
        self.nb_wires = 0

    @property
    def nb_constraints(self) -> int:
        """R1CS count: one per variable x variable product, one per assertion."""
        return self.nb_multiplications + self.nb_assertions

    # -- lifting -------------------------------------------------------------
    def constant(self, v) -> Variable:
        if isinstance(v, Variable):
            return v
        return Variable(int(v) % scalar.P, True)

    def witness(self, v: int) -> Variable:
        self.nb_wires += 1
        return Variable(int(v) % scalar.P, False)

    def _lift(self, v) -> Variable:
        return v if isinstance(v, Variable) else self.constant(v)

    # -- linear ops (free: they fold into linear combinations) ---------------
    def add(self, a, b, *rest) -> Variable:
        terms = [self._lift(x) for x in (a, b, *rest)]
        val = 0
        for t in terms:
            val = scalar.add(val, t.value)
        return Variable(val, all(t.is_constant for t in terms))

    def sub(self, a, b) -> Variable:
        a, b = self._lift(a), self._lift(b)
        return Variable(scalar.sub(a.value, b.value), a.is_constant and b.is_constant)

    def neg(self, a) -> Variable:
        a = self._lift(a)
        return Variable(scalar.sub(0, a.value), a.is_constant)

    # -- multiplication (one constraint unless a side is constant) -----------
    def mul(self, a, b) -> Variable:
        a, b = self._lift(a), self._lift(b)
        if not a.is_constant and not b.is_constant:
            self.nb_multiplications += 1
        return Variable(scalar.mul(a.value, b.value), a.is_constant and b.is_constant)

    # -- assertions ----------------------------------------------------------
    def assert_is_equal(self, a, b) -> None:
        a, b = self._lift(a), self._lift(b)
        self.nb_assertions += 1
        if a.value != b.value:
            raise UnsatisfiedConstraint(f"{a.value} != {b.value}")
