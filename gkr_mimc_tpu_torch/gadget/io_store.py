"""IoStore: the ordered record of every GKR input and output a gadget
proves, the counterpart of gkr_mimc_tpu/gadget/io_store.py.

Host int values, plus a per-entry ``public`` flag standing in for the
reference's public/private wire partition: it decides which commitment
key slice each io value multiplies. The dump orders fix the MSM scalar
order and hence the Fiat-Shamir randomness: inputs[0] || inputs[1] ||
outputs for the multiexp, qPrime || inputs || outputs for the prover.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class IoStore:
    input_arity: int = 2
    inputs: list[list[int]] = field(default_factory=list)  # [arity][index]
    outputs: list[int] = field(default_factory=list)
    public: list[bool] = field(default_factory=list)  # per hash entry
    index: int = 0

    def __post_init__(self):
        if not self.inputs:
            self.inputs = [[] for _ in range(self.input_arity)]

    def push(self, inputs: list[int], output: int, public: bool = False) -> None:
        """Record one hash entry (io_store.go:49-89). `public` marks all of
        this entry's ios as public for the multiexp split."""
        if len(inputs) != self.input_arity:
            raise ValueError(
                f"expected {self.input_arity} inputs, got {len(inputs)}"
            )
        for i, v in enumerate(inputs):
            self.inputs[i].append(v)
        self.outputs.append(output)
        self.public.append(public)
        self.index += 1

    def dump_for_multiexp(self) -> list[int]:
        """inputs[0] ‖ inputs[1] ‖ ... ‖ outputs (io_store.go:93-110)."""
        res: list[int] = []
        for col in self.inputs:
            res.extend(col)
        res.extend(self.outputs)
        return res

    def dump_for_gkr_prover(self, qprime: list[int]) -> list[int]:
        """qPrime ‖ inputs ‖ outputs (io_store.go:117-136)."""
        if (1 << len(qprime)) != self.index:
            raise ValueError("bN is inconsistent with the index")
        return list(qprime) + self.dump_for_multiexp()

    def multiexp_public_mask(self) -> list[bool]:
        """Per-element public flag aligned with dump_for_multiexp — the
        analog of the wire-ID partition of cs.go:39-91."""
        return self.public * (self.input_arity + 1)

    def inputs_for_verifier(self) -> list[list[int]]:
        return [list(col) for col in self.inputs]

    def outputs_for_verifier(self) -> list[int]:
        return list(self.outputs)
