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

Round selection follows the reference's kernel path
(gkr_mimc_tpu/sumcheck/prover.py:217-228, 276-437), by gate:

* a cipher gate over 2 tables with one claim runs Gruen-factored head
  rounds (suffix eq tables, ``ops.kernels.gruen_acc``, the fused round
  stage ``ops.kernels.gruen_round_scalar``, the fold of x0 and x1) while
  the tables are larger than 2**tail_bits;
* an identity gate over 1 table runs coefficient-form head rounds
  (``ops.kernels.identity_acc``) on the eq table of ``_make_eq``;
* everything else, and every table of at most 2**tail_bits entries, takes
  the generic evaluation-form round in plain torch field ops (the
  reference leaves these to XLA).

Every multi-claim layer builds its eq table per lane with the single-pass
hi/lo contraction (``ops.kernels.multi_eq``). Transcripts do not depend on
the split: all paths compute the same round polynomial exactly.

The reference runs its tail rounds at a fixed, masked table size so one
compiled program serves every round; PyTorch runs eagerly, so the tail
rounds here work on the halving tables themselves, which gives the same
values.
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


def _make_eq(qprimes: torch.Tensor, claims: torch.Tensor, lo_bits: int) -> torch.Tensor:
    """Combined eq table sum_j rlc^j eq(q_j, x) with rlc = MimcHash(claims)
    (no rlc for one claim): qprimes (J, bn, 8), claims (8, J) -> (8, 2**bn).

    Multi-claim: eq(q, x) = eq(q_hi, x_hi) * eq(q_lo, x_lo), so the table is
    one contraction of tiny per-claim hi tables (multipliers folded in) with
    per-claim lo tables over the last min(bn, lo_bits) variables
    (gkr_mimc_tpu/sumcheck/prover.py:161-193)."""
    j, bn = qprimes.shape[0], qprimes.shape[1]
    if j == 1:
        return multilin.eq_table(qprimes[0])
    rlc = mimc_hash_device(claims)
    ms = fr.one((1,), qprimes.device)  # rlc^0 .. rlc^(2^s - 1)
    power = rlc  # rlc^(2^s)
    while ms.shape[1] < j:
        ms = torch.cat([ms, fr.mul(ms, power.reshape(L, 1))], dim=1)
        power = fr.mul(power, power)
    hi_bits = bn - min(bn, lo_bits)
    hi = multilin.eq_table_grouped(qprimes[:, :hi_bits].transpose(0, 1), multiplier=ms[:, :j])
    lo = multilin.eq_table_grouped(qprimes[:, hi_bits:].transpose(0, 1))
    return K.multi_eq(hi.permute(2, 0, 1).contiguous(), lo.contiguous())


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


def _stack_t(tables: torch.Tensor, n_evals: int) -> torch.Tensor:
    """(8, T, G, 2m) -> (8, T, n_evals, G, m): the restriction of each
    table to the leading variable at t = 0, 1, ..., n_evals - 1, by
    repeated adds of (top - bot)."""
    m = tables.shape[-1] // 2
    bot, top = tables[..., :m], tables[..., m:]
    d = fr.sub(top, bot)
    rows = [bot, top]
    for _ in range(n_evals - 2):
        rows.append(fr.add(rows[-1], d))
    return torch.stack(rows, dim=2)


def _generic_round(gate: Gate, params, eq, xs):
    """Evaluation-form round on (8, G, n) tables: evaluations at
    t = 0..deg+1, interpolation, challenge, plain folds. Returns
    (eq, xs, coeffs (8, deg+2, G), r (8, G))."""
    n_evals = gate.degree + 2
    tables = torch.stack([eq] + list(xs), dim=1)  # (8, 1 + k, G, n)
    at_t = _stack_t(tables, n_evals)
    g = gate.eval_batch(params, list(at_t[:, 1:].unbind(1)))
    evals = fr.reduce_sum(fr.mul(at_t[:, 0], g), 2)  # (8, n_evals, G)
    coeffs = lagrange.interpolate_on_range_device(evals)
    r = _challenge(coeffs)
    folded = multilin.fold(tables, r).unbind(1)
    return folded[0], list(folded[1:]), coeffs, r


def _identity_round(eq, x):
    """Coefficient-form identity round (gkr_mimc_tpu/sumcheck/prover.py:
    416-437) on (8, G, n) tables: P0..P2 from the kernel, challenge, fold
    of eq and x."""
    g = eq.shape[1]
    coeffs = K.identity_acc(eq.reshape(L, -1), x.reshape(L, -1), g)  # (8, 3, G)
    r = _challenge(coeffs)
    eq, x = K.fold([eq.reshape(L, -1), x.reshape(L, -1)], r)
    return eq.reshape(L, g, -1), x.reshape(L, g, -1), coeffs, r


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


def _gruen_head(params, xs, q, n_head, coeffs_out, rs_out):
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
    ark = params[0].reshape(L, 1).expand(L, g).contiguous()
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
          tail_bits: int = TAIL_BITS, lo_bits: int = LO_BITS) -> SumcheckProof:
    """Single instance: xs tables (8, 2**bn); qprimes (J, bn, 8) evaluation
    points; claims (8, J) claimed values (used only for the Fiat-Shamir
    RLC), or None for the output layer (then J = 1).

    Grouped: xs (8, G, 2**bn); qprimes (J, bn, G, 8); claims (8, J, G) or
    None. The proof tensors gain a G axis before the limb axis."""
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
    coeffs, rs = [], []
    if kind == "cipher" and j == 1 and bn > tail_bits:
        flat = [x.reshape(L, g * n) for x in xs]
        eq, xs = _gruen_head(params, flat, qprimes[0], bn - tail_bits, coeffs, rs)
    else:
        eq = _make_eq_lanes(qprimes, claims, lo_bits)
        xs = [x.reshape(L, g, n) for x in xs]
        while kind == "identity" and eq.shape[-1] > 1 << tail_bits:
            eq, x, c, r = _identity_round(eq, xs[0])
            xs = [x]
            coeffs.append(c)
            rs.append(r)
    while eq.shape[-1] > 1:
        eq, xs, c, r = _generic_round(gate, params, eq, xs)
        coeffs.append(c)
        rs.append(r)
    return _package(coeffs, rs, eq, xs, gate.degree + 2, grouped)
