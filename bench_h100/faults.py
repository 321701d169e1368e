"""Faults planted in the program under the benchmark, to show that the check
fails them. Each is a context manager that swaps one of the program's
kernel wrappers (callers resolve ``ops.kernels.<name>`` at call time) or
the prover's output for the length of a run; none is used by a measured
run.

* ``skip_last_round``: the control. The witness's last MiMC round returns
  its state unchanged, so every output is MiMC-90 where the configuration
  states MiMC-91 (a guarantee broken, the step that would save a round).
* ``half_batch``: the witness leaves the second half of the instances out
  (zero tables there).
* ``altered_answer``: one entry of the output table is altered where the
  witness produces it.
* ``tampered_proof``: one round coefficient of one layer is altered after
  the walk.

A run on one card has no exchange between chips, so that fault has no
counterpart here.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("skip_last_round", "half_batch", "altered_answer", "tampered_proof")
CONTROL = "skip_last_round"


def _is_last_round(arks: torch.Tensor) -> bool:
    """Whether a witness launch ends at round 91 (its last ark is Ark[90])."""
    ark = importlib.import_module("gkr_mimc_tpu_torch.hashes.ark")
    last = ark.arks_mont(91, arks.device)[90]
    return bool(torch.equal(arks[-1], last))


@contextlib.contextmanager
def planted(name: str | None, prover=None):
    """Plant fault ``name`` (None plants nothing) for the duration."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    K = importlib.import_module("gkr_mimc_tpu_torch.ops.kernels")
    real_witness = K.mimc_witness

    def witness(block, state, arks):
        out = real_witness(block, state, arks)
        if name == "skip_last_round" and _is_last_round(arks):
            out[-1] = out[-2] if out.shape[0] > 1 else state.view_as(out[-1])
        elif name == "half_batch":
            out[..., out.shape[-1] // 2 :] = 0
        elif name == "altered_answer" and _is_last_round(arks):
            out[-1, 0, out.shape[-1] // 3] += 1
        return out

    real_prove = prover.prove if prover is not None else None

    def prove(wit, q):
        proof = real_prove(wit, q)
        coeffs = proof.sumcheck_proofs[len(proof.sumcheck_proofs) // 2].coeffs
        coeffs[(0,) * (coeffs.dim() - 1)] += 1
        return proof

    try:
        if name == "tampered_proof":
            prover.prove = prove
        else:
            K.mimc_witness = witness
        yield
    finally:
        K.mimc_witness = real_witness
        if real_prove is not None:
            prover.prove = real_prove
