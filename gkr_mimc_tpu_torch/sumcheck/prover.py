"""Multi-claim sumcheck prover on the device, single-instance or grouped.

Proves, for claims j: sum_i eq(qPrime[j], i) * Gate(X[0][i], ..., X[k-1][i]),
the claims combined by a random linear combination, with the reference's
transcript (gkr_mimc_tpu/sumcheck/prover.py): per round the univariate's
coefficients, the challenge r = MimcHash(coefficients), then a fold of
every table at r.

Grouped mode proves G independent instances in one pass: tables
(8, G, N), qprimes (J, bn, G, 8), claims (8, J, G); every round hashes
the G transcripts in lockstep lanes, and each lane's proof equals the
single-instance proof of that lane's inputs. Internally a single instance
is the grouped case with G = 1; the kernels take group-major (8, G*n)
views of the tables.

Head rounds (tables larger than 2**tail_bits) of a cipher gate over 2
tables or an identity gate over 1 table run on the kernels. ``rounds``
picks among the reference's three round paths, which its environment
switches select (gkr_mimc_tpu/sumcheck/prover.py:243-252, 440-471):

* ``"gruen"`` (the reference's defaults): a single-claim cipher layer runs
  Gruen-factored head rounds (suffix eq tables, ``ops.kernels.gruen_acc``,
  the fused round stage ``ops.kernels.gruen_round_scalar``, the fold of
  x0 and x1); every other layer runs coefficient-form head rounds on the
  eq table of ``_make_eq`` (``ops.kernels.cipher_coeff_acc`` or
  ``identity_acc``, the hash, one fold of eq and the tables);
* ``"coeff"`` (GKR_GRUEN=0): coefficient-form head rounds in every layer;
* ``"evals"`` (GKR_COEFF_PE=0): evaluation-form head rounds
  (``ops.kernels.cipher_partial_evals`` or ``identity_partial_evals``,
  interpolation, the hash, the fold) with the claim trick: the round sums
  skip t = 0 and P(0) = claim - P(1), the claim carried from round to
  round as P(r); a layer without claims (the output layer) computes its
  first round at every t.

Once the tables hold at most 2**tail_bits entries, a cipher or identity
layer runs all its remaining rounds in one launch, ``ops.kernels.
tail_rounds`` (gate sums, interpolation, challenge and folds of every tail
round), as the reference runs its tail as one compiled masked program
(gkr_mimc_tpu/sumcheck/prover.py:559-579). Every other gate takes the
generic evaluation-form round in plain torch field ops
(``ops.kernels.generic_round``; the reference leaves these to XLA), head
and tail. Transcripts do not depend on the path or the split: all paths
compute the same round polynomials exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuits.gates import CipherGate, Gate, IdentityGate
from ..fields import fr
from ..fields.bn254 import L
from ..hashes.mimc import mimc_hash_device
from ..ops import kernels as K
from ..poly import lagrange, multilin

TAIL_BITS = 8  # tables of at most 2**TAIL_BITS entries take generic rounds
LO_BITS = 10  # low variables of the multi-claim eq factorization
MULTI_EQ_MIN_BITS = 13  # single-claim eq tables this large take the hi/lo contraction
ROUNDS = ("gruen", "coeff", "evals")


@dataclass
class SumcheckProof:
    """coeffs (bn, deg+2[, G], 8): round-k univariate in coefficient form;
    challenges (bn[, G], 8); final_claims (k+1[, G], 8) = [eq(challenges),
    X_0, ...]. All canonical Montgomery rows; a grouped proof carries the G
    axis just before the limb axis."""

    coeffs: torch.Tensor
    challenges: torch.Tensor
    final_claims: torch.Tensor


def canon_rows(t: torch.Tensor) -> torch.Tensor:
    """Canonicalize limb-last rows."""
    return fr.canonicalize(t.movedim(-1, 0)).movedim(0, -1).contiguous()


def _challenge(coeffs: torch.Tensor) -> torch.Tensor:
    """Each lane's transcript hash: coefficients (8, K, G) -> r (8, G). One
    lane goes to the G = 1 hash kernel."""
    if coeffs.shape[-1] == 1:
        return mimc_hash_device(coeffs[:, :, 0]).reshape(L, 1)
    return mimc_hash_device(coeffs)


# ---------------------------------------------------------------------------
# Eq tables
# ---------------------------------------------------------------------------


def _rlc_multipliers(claims: torch.Tensor) -> torch.Tensor:
    """rlc^j, j = 0..J-1, per lane with rlc = MimcHash(the lane's claims):
    claims (8, J, G) -> (8, max(J, 1), G). One claim, or none (the output
    layer), takes no hash (the reference computes none: its value would
    never reach the transcript)."""
    j, g = claims.shape[1], claims.shape[2]
    ms = fr.one((1, g), claims.device)  # rlc^0 .. rlc^(2^s - 1)
    if j <= 1:
        return ms
    power = _challenge(claims).reshape(L, 1, g)  # rlc^(2^s)
    while ms.shape[1] < j:
        ms = torch.cat([ms, fr.mul(ms, power)], dim=1)
        power = fr.mul(power, power)
    return ms[:, :j]


def _make_eq(qprimes: torch.Tensor, claims: torch.Tensor, lo_bits: int) -> torch.Tensor:
    """Combined eq table sum_j rlc^j eq(q_j, x) with rlc = MimcHash(claims)
    (no rlc for one claim): qprimes (J, bn, 8), claims (8, J) -> (8, 2**bn).

    As the reference (gkr_mimc_tpu/sumcheck/prover.py:122-193): one claim
    below 2**13 entries takes the doubling build of ``multilin.eq_table``;
    otherwise eq(q, x) = eq(q_hi, x_hi) * eq(q_lo, x_lo), so the table is
    one contraction of tiny per-claim hi tables (multipliers folded in, one
    for a single claim) with per-claim lo tables over the last
    min(bn, lo_bits) variables."""
    j, bn = qprimes.shape[0], qprimes.shape[1]
    if j == 1 and bn < MULTI_EQ_MIN_BITS:
        return multilin.eq_table(qprimes[0])
    return eq_contraction(qprimes, _rlc_multipliers(claims.unsqueeze(-1))[..., 0], lo_bits)


def eq_contraction(qprimes: torch.Tensor, ms: torch.Tensor, lo_bits: int) -> torch.Tensor:
    """sum_j ms_j eq(q_j, x) as one ``multi_eq`` contraction of per-claim hi
    tables (the multipliers folded in) with per-claim lo tables over the
    last min(bn, lo_bits) variables: qprimes (J, bn, 8), ms (8, J) ->
    (8, 2**bn)."""
    bn = qprimes.shape[1]
    hi_bits = bn - min(bn, lo_bits)
    hi = multilin.eq_table_grouped(qprimes[:, :hi_bits].transpose(0, 1), multiplier=ms)
    lo = multilin.eq_table_grouped(qprimes[:, hi_bits:].transpose(0, 1))
    return K.multi_eq(hi.permute(2, 0, 1).contiguous(), lo.contiguous())


def _combined_claim(claims: torch.Tensor):
    """The RLC-combined claimed sum per lane, claim_0 + sum_{j>=1} rlc^j
    claim_j with the multipliers of ``_make_eq`` (reference :535-556):
    claims (8, J, G) -> (8, G); None without claims (the output layer)."""
    j = claims.shape[1]
    if j == 0:
        return None
    if j == 1:
        return claims[:, 0]
    return fr.reduce_sum(fr.mul(_rlc_multipliers(claims), claims), 0)


def _make_eq_lanes(qprimes: torch.Tensor, claims: torch.Tensor, lo_bits: int) -> torch.Tensor:
    """One ``_make_eq`` per lane, as the reference builds grouped eq tables
    at bn >= 10 (gkr_mimc_tpu/sumcheck/prover.py:136-145); the lane's RLC
    is the lane of the lockstep grouped hash: qprimes (J, bn, G, 8),
    claims (8, J, G) -> (8, G, 2**bn)."""
    lanes = [_make_eq(qprimes[:, :, i].contiguous(), claims[:, :, i].contiguous(), lo_bits)
             for i in range(qprimes.shape[2])]
    return lanes[0].unsqueeze(1) if len(lanes) == 1 else torch.stack(lanes, dim=1)


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------


def _generic_round(gate: Gate, params, eq, xs):
    """Evaluation-form round on (8, G, n) tables through the gate's
    ``eval_batch`` and the transcript hash. Returns (eq, xs, coeffs
    (8, deg+2, G), r (8, G))."""
    return K.generic_round(lambda xs_t: gate.eval_batch(params, xs_t), gate.degree + 2, eq, xs, _challenge)


def _tail(kind: str, params, eq, xs, coeffs_out, rs_out):
    """Every remaining round of a cipher or identity layer in one
    ``tail_rounds`` launch; returns the final (8, G, 1) eq and tables."""
    ark = params[0] if kind == "cipher" else None
    coeffs, rs, finals = K.tail_rounds(eq.contiguous(), [x.contiguous() for x in xs], ark)
    coeffs_out += coeffs.unbind(0)
    rs_out += rs.unbind(0)
    finals = finals.unsqueeze(-1).unbind(0)
    return finals[0], list(finals[1:])


def _fold_all(flat: list, r: torch.Tensor, g: int):
    """One fold launch over [eq] + xs (group-major) -> (eq, xs) as
    (8, G, n/2) tables."""
    folded = [t.reshape(L, g, -1) for t in K.fold(flat, r)]
    return folded[0], folded[1:]


def _coeff_round(kind: str, ark, eq, xs):
    """Coefficient-form head round (gkr_mimc_tpu/sumcheck/prover.py:
    404-437) on (8, G, n) tables: P_0..P_deg+1 from the kernel, challenge,
    one fold of eq and the tables."""
    g = eq.shape[1]
    flat = [t.reshape(L, -1) for t in [eq] + xs]
    if kind == "cipher":
        coeffs = K.cipher_coeff_acc(*flat, ark, g)  # (8, 9, G)
    else:
        coeffs = K.identity_acc(*flat, g)  # (8, 3, G)
    r = _challenge(coeffs)
    eq, xs = _fold_all(flat, r, g)
    return eq, xs, coeffs, r


def _with_t0(evals, claim):
    """Prepend P(0) = claim - P(1) to evaluations at t = 1.. (the claim
    trick, reference :231-240); no claim: the evaluations start at t = 0."""
    if claim is None:
        return evals
    return torch.cat([fr.sub(claim, evals[:, 0]).unsqueeze(1), evals], dim=1)


def _evals_round(kind: str, n_evals: int, ark, eq, xs, claim):
    """Evaluation-form head round (reference :450-471) on (8, G, n)
    tables: the round sums at t = 1..deg+1 (t = 0.. without a claim),
    P(0) from the claim, interpolation, challenge, the next claim P(r), one
    fold. Returns (eq, xs, coeffs, r, next claim)."""
    g = eq.shape[1]
    skip = claim is not None
    flat = [t.reshape(L, -1) for t in [eq] + xs]
    if kind == "cipher":
        evals = K.cipher_partial_evals(*flat, ark, g, n_evals, skip)
    else:
        evals = K.identity_partial_evals(*flat, g, n_evals, skip)
    coeffs = lagrange.interpolate_on_range_device(_with_t0(evals, claim))  # (8, deg+2, G)
    r = _challenge(coeffs)
    claim = lagrange.eval_univariate_device(coeffs, r)
    eq, xs = _fold_all(flat, r, g)
    return eq, xs, coeffs, r, claim


def _suffix_tables(qcols: torch.Tensor, n_head: int) -> list:
    """[T_0 .. T_{n_head-1}] per group: qcols (bn, 8, G) holds q_j of every
    group as a column; T_k is the eq table over the variables k+1..bn-1
    (MSB first), group-major (8, G * 2**(bn-1-k)), built back to front by
    suffix doubling steps."""
    bn, g = qcols.shape[0], qcols.shape[2]
    t = fr.one((g,), qcols.device)
    out = {bn - 1: t}
    for j in range(bn - 1, 0, -1):
        t = K.suffix_step(t, qcols[j])
        out[j - 1] = t
    return [out[k] for k in range(n_head)]


def _gruen_head(ark, xs, q, n_head, coeffs_out, rs_out):
    """Gruen-factored head rounds of a single-claim cipher layer
    (gkr_mimc_tpu/sumcheck/prover.py:332-398, fused round stage):
    eq(q, (r_<k, t, y)) = c_k * eq1(q_k, t) * S_k[y], so each round
    contracts against the challenge-free suffix table S_k, one kernel
    turns the sums into the coefficients, the challenge and c_{k+1}, and
    only x0, x1 fold. xs: group-major (8, G*n); q (bn, G, 8). Returns the
    tail's eq table c_K * T_{K-1} and tables, (8, G, m)."""
    g = q.shape[1]
    qcols = q.permute(0, 2, 1).contiguous()  # (bn, 8, G)
    suffix = _suffix_tables(qcols, n_head)
    qk = qcols[:n_head].permute(1, 0, 2)  # (8, n_head, G)
    one = fr.one((n_head, g), q.device)
    alphas = fr.sub(one, qk).permute(1, 0, 2).contiguous()  # (n_head, 8, G)
    betas = fr.sub(fr.add(qk, qk), one).permute(1, 0, 2).contiguous()
    ck = fr.one((g,), q.device)
    x0, x1 = xs
    for k in range(n_head):
        qc = K.gruen_acc(suffix[k], x0, x1, ark)  # (8, 8, G)
        coeffs, r, ck = K.gruen_round_scalar(qc, alphas[k], betas[k], ck, qcols[k])
        x0, x1 = K.fold([x0, x1], r)
        coeffs_out.append(coeffs)
        rs_out.append(r)
    eq = fr.mul(suffix[n_head - 1].reshape(L, g, -1), ck.reshape(L, g, 1))
    return eq, [x0.reshape(L, g, -1), x1.reshape(L, g, -1)]


def _kernel_kind(gate: Gate, xs) -> str | None:
    if isinstance(gate, CipherGate) and len(xs) == 2:
        return "cipher"
    if isinstance(gate, IdentityGate) and len(xs) == 1:
        return "identity"
    return None


def _package(coeffs, rs, eq, xs, n_evals: int, grouped: bool) -> SumcheckProof:
    """Per-round (8, E, G) coefficients and (8, G) challenges, and the
    final (8, G, 1) tables -> canonical rows, the limb axis last and the G
    axis before it (dropped for a single instance)."""
    g = eq.shape[1]
    device = eq.device
    final = torch.stack([eq[:, :, 0]] + [x[:, :, 0] for x in xs], dim=0).permute(0, 2, 1)
    if coeffs:
        proof = torch.stack(coeffs, dim=0).permute(0, 2, 3, 1)  # (bn, E, G, 8)
        chals = torch.stack(rs, dim=0).permute(0, 2, 1)  # (bn, G, 8)
    else:
        proof = torch.zeros((0, n_evals, g, L), dtype=torch.int32, device=device)
        chals = torch.zeros((0, g, L), dtype=torch.int32, device=device)
    if not grouped:
        proof, chals, final = proof[:, :, 0], chals[:, 0], final[:, 0]
    return SumcheckProof(coeffs=canon_rows(proof), challenges=canon_rows(chals),
                         final_claims=canon_rows(final))


def prove(xs: list, qprimes: torch.Tensor, claims, gate: Gate,
          tail_bits: int = TAIL_BITS, lo_bits: int = LO_BITS, rounds: str = "gruen") -> SumcheckProof:
    """Single instance: xs tables (8, 2**bn); qprimes (J, bn, 8) evaluation
    points; claims (8, J) claimed values (used only for the Fiat-Shamir
    RLC), or None for the output layer (then J = 1).

    Grouped: xs (8, G, 2**bn); qprimes (J, bn, G, 8); claims (8, J, G) or
    None. The proof tensors gain a G axis before the limb axis.

    rounds: the head-round path, one of ``ROUNDS`` (module docstring); the
    proof does not depend on it."""
    if rounds not in ROUNDS:
        raise ValueError(f"rounds={rounds!r}, expected one of {ROUNDS}")
    grouped = qprimes.dim() == 4
    j, bn = qprimes.shape[0], qprimes.shape[1]
    g = qprimes.shape[2] if grouped else 1
    n = 1 << bn
    device = qprimes.device
    for x in xs:
        want = (L, g, n) if grouped else (L, n)
        if tuple(x.shape) != want:
            raise ValueError(f"table shape {tuple(x.shape)}, expected {want}")
    if not grouped:
        qprimes = qprimes.unsqueeze(2)
        claims = None if claims is None else claims.unsqueeze(-1)
    if claims is None:
        if j != 1:
            raise ValueError("a layer without claims takes exactly one qPrime")
        claims = fr.zeros((0, g), device)
    params = gate.params(device)
    kind = _kernel_kind(gate, xs)
    ark = params[0].reshape(L, 1).expand(L, g).contiguous() if kind == "cipher" else None
    coeffs, rs = [], []
    if rounds == "gruen" and kind == "cipher" and j == 1 and bn > tail_bits:
        flat = [x.reshape(L, g * n) for x in xs]
        eq, xs = _gruen_head(ark, flat, qprimes[0], bn - tail_bits, coeffs, rs)
    else:
        eq = _make_eq_lanes(qprimes, claims, lo_bits)
        xs = [x.reshape(L, g, n) for x in xs]
        if kind is not None and bn > tail_bits:
            claim = _combined_claim(claims) if rounds == "evals" else None
            while eq.shape[-1] > 1 << tail_bits:
                if rounds == "evals":
                    eq, xs, c, r, claim = _evals_round(kind, gate.degree + 2, ark, eq, xs, claim)
                else:
                    eq, xs, c, r = _coeff_round(kind, ark, eq, xs)
                coeffs.append(c)
                rs.append(r)
    while eq.shape[-1] > (1 if kind is None else 1 << K.TAIL_MAX_BITS):
        eq, xs, c, r = _generic_round(gate, params, eq, xs)
        coeffs.append(c)
        rs.append(r)
    if kind is not None and eq.shape[-1] > 1:
        eq, xs = _tail(kind, params, eq, xs, coeffs, rs)
    return _package(coeffs, rs, eq, xs, gate.degree + 2, grouped)
