"""Layered circuit DAG and witness assignment (the reference's
gkr_mimc_tpu/circuits/circuit.py).

A Circuit is a list of layers; a layer lists its input layer indices
(empty => input layer) and a gate. ``build()`` computes the sorted consumer
(``out``) lists and enforces the explicit multi-instance rule: an input
used more than once must go through an Identity layer. ``assign`` builds
the full witness, one ``eval_batch`` over the whole table per layer.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional

from .gates import Gate


@dataclass
class Layer:
    in_: list[int]
    gate: Optional[Gate] = None
    out: list[int] = field(default_factory=list)


class Circuit(list):
    """A list of Layers with computed wiring metadata."""

    def __init__(self, layers):
        super().__init__(layers)
        self.build()

    def build(self):
        for l in self:
            l.out = []
        for idx, l in enumerate(self):
            for pos in l.in_:
                self[pos].out.append(idx)
        for idx, l in enumerate(self):
            l.out.sort()
            if not l.in_ and len(l.out) > 1:
                raise ValueError(
                    f"layer {idx} is an input layer but has {len(l.out)} consumers; "
                    "multi-instances must be explicit Identity layers"
                )

    def is_input_layer(self, layer: int) -> bool:
        has_no_inputs = len(self[layer].in_) == 0
        if has_no_inputs != (self[layer].gate is None):
            raise ValueError(f"layer {layer} input/gate flags disagree")
        return has_no_inputs

    def input_arity(self) -> int:
        """The number of leading input layers."""
        count = 0
        for layer in range(len(self)):
            if not self.is_input_layer(layer):
                break
            count += 1
        return count

    def out_slot(self, inp_layer: int, consumer: int) -> int:
        """Position of `consumer` in self[inp_layer].out: the claim slot
        shared by prover and verifier."""
        out = self[inp_layer].out
        pos = bisect.bisect_left(out, consumer)
        if pos == len(out) or out[pos] != consumer:
            raise ValueError(f"layer {consumer} is not a consumer of {inp_layer}")
        return pos


def assign(circuit: Circuit, inputs: list) -> list:
    """Full witness: a[l] = the (8, N) table (grouped: (8, G, N)) of layer l
    over all instances, every layer resident; the inputs come first."""
    a: list = [None] * len(circuit)
    a[: len(inputs)] = inputs
    for l in range(len(inputs), len(circuit)):
        layer = circuit[l]
        a[l] = layer.gate.eval_batch(layer.gate.params(inputs[0].device), [a[j] for j in layer.in_])
    return a


def assign_scalar(circuit: Circuit, inputs: list[list[int]]) -> list[list[int]]:
    """Host-int oracle of ``assign``: inputs as lists of field ints."""
    a: list = [None] * len(circuit)
    a[: len(inputs)] = [list(inp) for inp in inputs]
    for l in range(len(inputs), len(circuit)):
        layer = circuit[l]
        n = len(a[layer.in_[0]])
        a[l] = [layer.gate.eval_scalar([a[j][i] for j in layer.in_]) for i in range(n)]
    return a
