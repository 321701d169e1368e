"""The gates of the layered circuits (the reference's
gkr_mimc_tpu/circuits/gates.py): cipher and identity for MiMC; add, mul,
S-box, linear and affine for the GMiMC and Poseidon circuits.

A gate's parameters are Montgomery (8,) tensors, cached per device. The
cipher and S-box gates evaluate through the ``cipher_layer`` and ``pow7``
kernels (``ops.kernels``), which take their plain twins on CPU tensors;
the degree-1 and degree-2 gates are plain field ops, as the reference
leaves them to XLA. ``gnark_eval`` evaluates a gate inside a constraint
system (``snark.cs`` or ``snark.r1cs``), for the in-circuit verifier.
"""

from __future__ import annotations

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L
from ..ops import kernels as K


class Gate:
    """degree: the gate's degree in hPrime."""

    name: str = "Gate"
    degree: int = 1
    arity: int = 2
    consts: tuple = ()  # field ints behind params()

    def params(self, device=None) -> tuple:
        """The gate's constants as Montgomery (8,) tensors on `device`."""
        dev = torch.device(device or "cpu")
        cache = self.__dict__.setdefault("_params", {})
        if dev not in cache:
            cache[dev] = tuple(fr.from_int_mont(c, dev) for c in self.consts)
        return cache[dev]

    def eval_batch(self, params, xs: list) -> torch.Tensor:
        """xs: list of (8, *S) Montgomery tensors -> (8, *S)."""
        raise NotImplementedError

    def eval_scalar(self, xs: list[int]) -> int:
        """Host oracle on Python ints."""
        raise NotImplementedError

    def gnark_eval(self, cs, xs):
        """The gate inside a constraint system; xs are its variables."""
        raise NotImplementedError


def _pow7_in_circuit(cs, t):
    """t^7 as the 4-multiply chain of the reference's cipher gate."""
    tmp = cs.mul(t, t)  # ^2
    tmp = cs.mul(t, tmp)  # ^3
    tmp = cs.mul(tmp, tmp)  # ^6
    return cs.mul(t, tmp)  # ^7


def _bcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (8,) parameter shaped to broadcast against an (8, *S) batch."""
    return p.reshape((L,) + (1,) * (x.dim() - 1))


class CipherGate(Gate):
    """(vL + vR + Ark)^7: one MiMC round."""

    name = "CipherGate"
    degree = 7

    def __init__(self, ark: int):
        self.ark = ark % scalar.P
        self.consts = (self.ark,)

    def eval_batch(self, params, xs):
        (ark,) = params
        return K.cipher_layer_batch(xs[0], xs[1], ark)

    def eval_scalar(self, xs):
        return scalar.pow7(scalar.add(scalar.add(xs[1], self.ark), xs[0]))

    def gnark_eval(self, cs, xs):
        return _pow7_in_circuit(cs, cs.add(xs[0], xs[1], cs.constant(self.ark)))


class IdentityGate(Gate):
    """Copies vL: the explicit multi-instance fan-out gate."""

    name = "IdentityGate"
    degree = 1
    arity = 1

    def eval_batch(self, params, xs):
        return xs[0]

    def eval_scalar(self, xs):
        return xs[0]

    def gnark_eval(self, cs, xs):
        return xs[0]


class AddGate(Gate):
    """vL + vR."""

    name = "AddGate"
    degree = 1

    def eval_batch(self, params, xs):
        return fr.add(xs[0], xs[1])

    def eval_scalar(self, xs):
        return scalar.add(xs[0], xs[1])

    def gnark_eval(self, cs, xs):
        return cs.add(xs[0], xs[1])


class MulGate(Gate):
    """vL * vR."""

    name = "MulGate"
    degree = 2

    def eval_batch(self, params, xs):
        return fr.mul(xs[0], xs[1])

    def eval_scalar(self, xs):
        return scalar.mul(xs[0], xs[1])

    def gnark_eval(self, cs, xs):
        return cs.mul(xs[0], xs[1])


class SBoxGate(Gate):
    """vL^7 on a single input."""

    name = "SBoxGate"
    degree = 7
    arity = 1

    def eval_batch(self, params, xs):
        return K.pow7_batch(xs[0])

    def eval_scalar(self, xs):
        return scalar.pow7(xs[0])

    def gnark_eval(self, cs, xs):
        return _pow7_in_circuit(cs, xs[0])


class LinearGate(Gate):
    """sum_j c_j * v_j + c_const over k inputs: the MDS-row gate of the
    Poseidon circuit. Degree 1 in hPrime."""

    name = "LinearGate"
    degree = 1

    def __init__(self, coeffs: list[int], const: int = 0):
        self.coeffs = [c % scalar.P for c in coeffs]
        self.const = const % scalar.P
        self.arity = len(coeffs)
        self.consts = tuple(self.coeffs) + ((self.const,) if self.const else ())

    def eval_batch(self, params, xs):
        acc = fr.mul(_bcast(params[0], xs[0]), xs[0])
        for j in range(1, self.arity):
            acc = fr.add(acc, fr.mul(_bcast(params[j], xs[j]), xs[j]))
        if self.const:
            acc = fr.add(acc, _bcast(params[self.arity], acc))
        return acc

    def eval_scalar(self, xs):
        acc = self.const
        for c, x in zip(self.coeffs, xs):
            acc = scalar.add(acc, scalar.mul(c, x))
        return acc

    def gnark_eval(self, cs, xs):
        acc = cs.constant(self.const)
        for c, x in zip(self.coeffs, xs):
            acc = cs.add(acc, cs.mul(cs.constant(c), x))
        return acc


class AffineGate(Gate):
    """c0*vL + c1*vR + c2: the word shift of the GMiMC chain and the ark
    addition of Poseidon's partial rounds."""

    name = "AffineGate"
    degree = 1

    def __init__(self, c0: int, c1: int, c2: int = 0):
        self.c0, self.c1, self.c2 = c0 % scalar.P, c1 % scalar.P, c2 % scalar.P
        self.consts = (self.c0, self.c1, self.c2)

    def eval_batch(self, params, xs):
        c0, c1, c2 = (_bcast(p, xs[0]) for p in params)
        return fr.add(fr.add(fr.mul(c0, xs[0]), fr.mul(c1, xs[1])), c2)

    def eval_scalar(self, xs):
        return scalar.add(scalar.add(scalar.mul(self.c0, xs[0]), scalar.mul(self.c1, xs[1])), self.c2)

    def gnark_eval(self, cs, xs):
        return cs.add(cs.mul(cs.constant(self.c0), xs[0]), cs.mul(cs.constant(self.c1), xs[1]), cs.constant(self.c2))
