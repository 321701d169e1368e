"""Recording constraint system: eager evaluation plus R1CS emission (the
counterpart of gkr_mimc_tpu/snark/r1cs.py).

The counting tracer (``snark.cs``) keeps the verification relation and the
cost model; this one also records the R1CS, so a Groth16 runs on top of it
(the reference gets this from the gnark frontend). The same eager model,
every variable carrying its value, plus:

  * wires: index 0 is the constant 1; public wires come first, then
    private ones (gnark's layout, which the Groth16 K-split relies on);
  * every variable carries a linear combination over wires; linear ops
    stay free, each variable x variable product allocates one wire and one
    constraint, each assertion emits one constraint;
  * each constraint's evaluated values (a, b, c) are recorded as it is
    traced: tracing is solving.

R1CS convention: constraint c is <A_c, z> * <B_c, z> = <C_c, z> over the
wire vector z with z[0] = 1.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import scalar
from .cs import UnsatisfiedConstraint

__all__ = ["CompiledR1CS", "RVariable", "RecordingCS", "UnsatisfiedConstraint"]


class RVariable:
    """Eager variable: its value and a linear combination over wires.

    lc: a tuple of (wire id, coefficient) pairs; constants use wire 0 (== 1).
    A plain __slots__ class: millions are made while tracing."""

    __slots__ = ("value", "is_constant", "lc")

    def __init__(self, value: int, is_constant: bool = False, lc: tuple = ()):
        self.value = value
        self.is_constant = is_constant
        self.lc = lc


def _lc_scale(lc: tuple, k: int) -> tuple:
    if k == 1:
        return lc
    return tuple((w, c * k % scalar.P) for w, c in lc)


def _lc_add(*lcs) -> tuple:
    acc: dict = {}
    for lc in lcs:
        for w, c in lc:
            acc[w] = (acc.get(w, 0) + c) % scalar.P
    return tuple((w, c) for w, c in acc.items() if c != 0)


class RecordingCS:
    """The API of ``snark.cs.ConstraintSystem``, recording the R1CS and the
    solution vector while checking each assertion eagerly."""

    def __init__(self):
        self.wire_values: list[int] = [1]  # wire 0 is the constant 1
        self.wire_public: list[bool] = [False]
        self.constraints: list[tuple] = []  # (A_lc, B_lc, C_lc)
        self.abc: list[tuple] = []  # evaluated (a, b, c) per constraint
        self.nb_multiplications = 0
        self.nb_assertions = 0
        self.nb_wires = 0

    @property
    def nb_constraints(self) -> int:
        return len(self.constraints)

    # -- wire allocation -----------------------------------------------------
    def _new_wire(self, v: int, public: bool) -> int:
        self.wire_values.append(v % scalar.P)
        self.wire_public.append(public)
        return len(self.wire_values) - 1

    def public_input(self, v: int) -> RVariable:
        self.nb_wires += 1
        w = self._new_wire(v, True)
        return RVariable(v % scalar.P, False, ((w, 1),))

    def witness(self, v: int) -> RVariable:
        self.nb_wires += 1
        w = self._new_wire(v, False)
        return RVariable(v % scalar.P, False, ((w, 1),))

    # -- lifting -------------------------------------------------------------
    def constant(self, v) -> RVariable:
        if isinstance(v, RVariable):
            return v
        v = int(v) % scalar.P
        return RVariable(v, True, ((0, v),) if v else ())

    def _lift(self, v) -> RVariable:
        return v if isinstance(v, RVariable) else self.constant(v)

    # -- linear ops (free) ---------------------------------------------------
    def add(self, a, b, *rest) -> RVariable:
        terms = [self._lift(x) for x in (a, b, *rest)]
        val = 0
        for t in terms:
            val = scalar.add(val, t.value)
        return RVariable(val, all(t.is_constant for t in terms), _lc_add(*(t.lc for t in terms)))

    def sub(self, a, b) -> RVariable:
        a, b = self._lift(a), self._lift(b)
        return RVariable(scalar.sub(a.value, b.value), a.is_constant and b.is_constant,
                         _lc_add(a.lc, _lc_scale(b.lc, scalar.P - 1)))

    def neg(self, a) -> RVariable:
        a = self._lift(a)
        return RVariable(scalar.sub(0, a.value), a.is_constant, _lc_scale(a.lc, scalar.P - 1))

    # -- multiplication ------------------------------------------------------
    def mul(self, a, b) -> RVariable:
        a, b = self._lift(a), self._lift(b)
        val = scalar.mul(a.value, b.value)
        if a.is_constant or b.is_constant:
            k, lc = (a.value, b.lc) if a.is_constant else (b.value, a.lc)
            return RVariable(val, a.is_constant and b.is_constant, _lc_scale(lc, k))
        self.nb_multiplications += 1
        w = self._new_wire(val, False)
        self.nb_wires += 1
        self.constraints.append((a.lc, b.lc, ((w, 1),)))
        self.abc.append((a.value, b.value, val))
        return RVariable(val, False, ((w, 1),))

    # -- assertions ----------------------------------------------------------
    def assert_is_equal(self, a, b) -> None:
        a, b = self._lift(a), self._lift(b)
        self.nb_assertions += 1
        self.constraints.append((a.lc, ((0, 1),), b.lc))  # a * 1 = b
        self.abc.append((a.value, 1, b.value))
        if a.value != b.value:
            raise UnsatisfiedConstraint(f"{a.value} != {b.value}")

    # -- a raw constraint (the gadget's placeholder) -------------------------
    def raw_constraint(self, a_lc, b_lc, c_lc, a_v, b_v, c_v) -> None:
        self.constraints.append((tuple(a_lc), tuple(b_lc), tuple(c_lc)))
        self.abc.append((a_v % scalar.P, b_v % scalar.P, c_v % scalar.P))

    # -- compilation ---------------------------------------------------------
    def compile(self) -> "CompiledR1CS":
        """Freeze into the canonical wire order [1, publics..., privates...]
        and remap every linear combination."""
        pub = [i for i in range(1, len(self.wire_values)) if self.wire_public[i]]
        priv = [i for i in range(1, len(self.wire_values)) if not self.wire_public[i]]
        remap = {0: 0}
        for j, i in enumerate(pub):
            remap[i] = 1 + j
        for j, i in enumerate(priv):
            remap[i] = 1 + len(pub) + j

        def m(lc):
            return tuple((remap[w], c) for w, c in lc)

        constraints = [(m(a), m(b), m(c)) for a, b, c in self.constraints]
        wires = [1] + [self.wire_values[i] for i in pub] + [self.wire_values[i] for i in priv]
        return CompiledR1CS(constraints=constraints, n_public=len(pub), n_wires=len(wires),
                            abc=list(self.abc), wires=wires, wire_map=remap)


@dataclass
class CompiledR1CS:
    """The R1CS in canonical wire order and the traced solution:
    wires[0] == 1, wires[1..n_public] public, the rest private."""

    constraints: list
    n_public: int
    n_wires: int
    abc: list
    wires: list
    wire_map: dict  # trace wire id -> canonical index

    def check(self) -> None:
        """Evaluate every constraint against the wire vector (an independent
        solve, gnark's IsSolved)."""
        z = self.wires

        def ev(lc):
            s = 0
            for w, c in lc:
                s = (s + z[w] * c) % scalar.P
            return s

        for i, (a, b, c) in enumerate(self.constraints):
            av, bv, cv = ev(a), ev(b), ev(c)
            if av * bv % scalar.P != cv:
                raise UnsatisfiedConstraint(f"constraint {i}: {av}*{bv} != {cv}")
