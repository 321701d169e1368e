"""The gates of the MiMC circuit: cipher and identity (the reference's
gkr_mimc_tpu/circuits/gates.py; the other gates come with other circuits)."""

from __future__ import annotations

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L


class Gate:
    """degree: the gate's degree in hPrime."""

    name: str = "Gate"
    degree: int = 1
    arity: int = 2

    def params(self, device=None) -> tuple:
        """Parameter tensors on `device`."""
        return ()

    def eval_batch(self, params, xs: list) -> torch.Tensor:
        """xs: list of (8, *S) Montgomery tensors -> (8, *S)."""
        raise NotImplementedError

    def eval_scalar(self, xs: list[int]) -> int:
        """Host oracle on Python ints."""
        raise NotImplementedError


class CipherGate(Gate):
    """(vL + vR + Ark)^7: one MiMC round."""

    name = "CipherGate"
    degree = 7

    def __init__(self, ark: int):
        self.ark = ark % scalar.P
        self._params: dict = {}

    def params(self, device=None) -> tuple:
        dev = torch.device(device or "cpu")
        if dev not in self._params:
            self._params[dev] = (fr.from_int_mont(self.ark, dev),)
        return self._params[dev]

    def eval_batch(self, params, xs):
        (ark,) = params
        a = ark.reshape((L,) + (1,) * (xs[0].dim() - 1))
        return fr.pow7(fr.add(fr.add(xs[1], a), xs[0]))

    def eval_scalar(self, xs):
        return scalar.pow7(scalar.add(scalar.add(xs[1], self.ark), xs[0]))


class IdentityGate(Gate):
    """Copies vL: the explicit multi-instance fan-out gate."""

    name = "IdentityGate"
    degree = 1
    arity = 1

    def eval_batch(self, params, xs):
        return xs[0]

    def eval_scalar(self, xs):
        return xs[0]
