"""A plain verifier of the MiMC-91 GKR proof, and a plain check of the hashes.

Written from the protocol of the Consensys gkr-mimc reference, on Python
ints (``field.py``) and plain PyTorch for the large multilinear
evaluations (``mle.py``). It imports nothing of the program under test and
takes from it only what it judges: the output table and the proof.

The circuit (94 layers): 0 the block (the key), 1 the state, 2 a copy of
the block (the identity gate), 3 + i for i = 0 .. 90 the MiMC round
(x_l + x_r + ark_i)^7 over layer 2 and the round before (layer 1 for
i = 0); layer 93 is the output, Perm_block(state).

Each sumcheck round k of a layer sends the coefficients of a univariate
P_k; the verifier checks P_k(0) + P_k(1) against the running claim and
takes r_k = MimcHash(coefficients) as the round's challenge. A layer with
J > 1 claims first folds them with rlc = MimcHash(claims) into
sum_j rlc^j claim_j. After the last round the running claim must equal
gate(claims on the inputs) * sum_j rlc^j eq(q_j, r); each input layer is
claimed at r. The output layer's claim is the verifier's own evaluation of
the output table at the initial point, and each input layer's claim must
equal the evaluation of the verifier's own input table.

The proof arrives as the program's tensors, moved to the host as numpy
int32 arrays, Montgomery words (R = 2^256) with the limb axis last and a
lane axis just before it in a grouped proof. Failures are counted, not
raised, so one number says how far a proof is from sound.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import mle
from .field import ARKS, P, RINV, ROUNDS, eq, horner, permutation
from .hashing import hash_all

N_LAYERS = ROUNDS + 3
OUTPUT = N_LAYERS - 1
IDENTITY_K = 3  # coefficients a round: degree 1 gate times eq
CIPHER_K = 9  # degree 7 gate times eq


def inputs_of(layer: int) -> list[int]:
    if layer < 2:
        return []
    if layer == 2:
        return [0]
    return [2, 1 if layer == 3 else layer - 1]


def consumers(layer: int) -> list[int]:
    return [c for c in range(N_LAYERS) if layer in inputs_of(c)]


def gate(layer: int, xs: list[int]) -> int:
    if layer == 2:
        return xs[0]
    t = (xs[0] + xs[1] + ARKS[layer - 3]) % P
    return pow(t, 7, P)


def decode(arr: np.ndarray) -> list:
    """(..., 8) Montgomery words -> nested lists of field ints."""
    a = np.ascontiguousarray(arr).astype("<i4")
    raw = a.tobytes()
    flat = [int.from_bytes(raw[32 * i : 32 * i + 32], "little") * RINV % P for i in range(len(raw) // 32)]
    return _nest(flat, a.shape[:-1])


def _nest(flat: list, shape: tuple):
    if not shape:
        return flat[0]
    if shape[0] == 0:
        return []
    step = len(flat) // shape[0]
    return [_nest(flat[i * step : (i + 1) * step], shape[1:]) for i in range(shape[0])]


@dataclass
class LaneProof:
    """One lane of a proof as field ints, per layer (None for the inputs'
    sumchecks): coeffs[l][k] the round polynomials, challenges[l][k],
    final[l] = [eq value, claim on each input], claims[l][j] and
    qprimes[l][j] for consumer slot j."""

    coeffs: list
    challenges: list
    final: list
    claims: list
    qprimes: list


@dataclass
class Report:
    failures: dict = field(default_factory=dict)

    def fail(self, kind: str, n: int = 1) -> None:
        self.failures[kind] = self.failures.get(kind, 0) + n

    @property
    def total(self) -> int:
        return sum(self.failures.values())


def lanes_of(proof: dict) -> list[LaneProof]:
    """The program's proof arrays -> one LaneProof a lane. ``proof`` holds
    lists over layers: "coeffs" (bn, K[, G], 8), "challenges" (bn[, G], 8),
    "final_claims" (k + 1[, G], 8), "claims" (J[, G], 8), "qprimes"
    (J, bn[, G], 8); grouped when a "lanes" entry > 0 says so."""
    g = proof.get("lanes", 0)

    def lane(arr, i):
        if arr is None:
            return None
        return decode(arr[..., i, :] if g else arr)

    out = []
    for i in range(max(g, 1)):
        out.append(LaneProof(*([lane(a, i) for a in proof[key]]
                               for key in ("coeffs", "challenges", "final_claims", "claims", "qprimes"))))
    return out


def messages(lane: LaneProof) -> list:
    """Every message the verifier hashes for one lane: each round's
    coefficients, and the claims of a layer with more than one."""
    out = []
    for l in range(N_LAYERS - 1, 1, -1):
        if lane.claims[l] and len(lane.claims[l]) > 1:
            out.append(list(lane.claims[l]))
        out.extend(list(c) for c in (lane.coeffs[l] or []))
    return out


def verify_lane(lane: LaneProof, hashes: dict, out_eval: int, qprime: list[int], bn: int,
                input_eval) -> Report:
    """Check one lane. hashes maps tuple(message) -> MimcHash(message);
    input_eval(layer, point) evaluates an input table at a point."""
    rep = Report()
    if lane.qprimes[OUTPUT] is None or [list(q) for q in lane.qprimes[OUTPUT]] != [list(qprime)]:
        rep.fail("initial_point")
    claims = {l: list(lane.claims[l] or []) for l in range(N_LAYERS)}
    claims[OUTPUT] = [out_eval]
    points = {OUTPUT: [list(qprime)]}
    for l in range(N_LAYERS - 1, 1, -1):
        k_want = IDENTITY_K if l == 2 else CIPHER_K
        coeffs = lane.coeffs[l]
        js = claims[l]
        qs = points.get(l) or []
        if (coeffs is None or len(coeffs) != bn or any(len(c) != k_want for c in coeffs)
                or len(js) != max(len(consumers(l)), 1) or len(qs) != len(js) or None in qs):
            rep.fail("shape")
            continue
        rlc = hashes[tuple(js)] if len(js) > 1 else 1
        running = horner(js, rlc)
        rs = []
        for k, c in enumerate(coeffs):
            if (c[0] + sum(c)) % P != running:
                rep.fail("round_sum")
            r = hashes[tuple(c)]
            rs.append(r)
            running = horner(c, r)
        if lane.challenges[l] is None or list(lane.challenges[l]) != rs:
            rep.fail("challenges")
        eq_sum = horner([eq(q, rs) for q in qs], rlc)
        subs = []
        for inp in inputs_of(l):
            slot = consumers(inp).index(l)
            stated = lane.qprimes[inp]
            if stated is None or slot >= len(stated) or list(stated[slot]) != rs:
                rep.fail("point")
            points.setdefault(inp, [None] * len(consumers(inp)))[slot] = rs
            subs.append(claims[inp][slot] if slot < len(claims[inp]) else 0)
        final = lane.final[l]
        if final is None or list(final) != [eq_sum] + subs:
            rep.fail("final_claims")
        if gate(l, subs) * eq_sum % P != running:
            rep.fail("final_check")
    for l in (0, 1):
        pt = (points.get(l) or [None])[0]
        if pt is None or not claims[l] or claims[l][0] != input_eval(l, pt):
            rep.fail("input")
    return rep


def check_proof(proof: dict, block: torch.Tensor, state: torch.Tensor, output: torch.Tensor, qprimes: list,
                workers: int = 1) -> Report:
    """Verify every lane of one proof.

    block, state: the benchmark's own input tables, standard form, (8, N)
    or (8, G, N) int32 words; output: the program's output table (the same
    shape, Montgomery words); qprimes: each lane's initial point (ints).
    The large evaluations run on the tables' device."""
    lanes = lanes_of(proof)
    grouped = block.dim() == 3
    bn = block.shape[-1].bit_length() - 1
    msgs = {tuple(m) for lane in lanes for m in messages(lane)}
    order = sorted(msgs)
    hashes = dict(zip(order, hash_all([list(m) for m in order], workers)))
    out_evals = [v * RINV % P for v in mle.evaluate(output, qprimes if grouped else qprimes[0])]
    rep = Report()
    for i, lane in enumerate(lanes):
        tables = [block[:, i] if grouped else block, state[:, i] if grouped else state]

        def input_eval(layer, point, tables=tables):
            return mle.evaluate(tables[layer], point)[0]

        sub = verify_lane(lane, hashes, out_evals[i], qprimes[i], bn, input_eval)
        for kind, n in sub.failures.items():
            rep.fail(kind, n)
    return rep


def hash_mismatches(block: torch.Tensor, state: torch.Tensor, output: torch.Tensor, columns: torch.Tensor) -> int:
    """How many of the sampled output entries differ from Perm_block(state)
    worked out here: columns (k,) flat indices into the instances (lane-major
    for a grouped table)."""
    flat = [t.reshape(8, -1)[:, columns].T.cpu().numpy() for t in (block, state, output)]
    bad = 0
    for b, s, o in zip(*flat):
        key = int.from_bytes(b.astype("<i4").tobytes(), "little")
        x = int.from_bytes(s.astype("<i4").tobytes(), "little")
        got = int.from_bytes(o.astype("<i4").tobytes(), "little") * RINV % P
        bad += got != permutation(x % P, key % P)
    return bad
