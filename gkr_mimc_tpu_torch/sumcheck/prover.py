"""Multi-claim sumcheck prover on the device.

Proves, for claims j: sum_i eq(qPrime[j], i) * Gate(X[0][i], ..., X[k-1][i]),
the claims combined by a random linear combination, with the reference's
transcript (gkr_mimc_tpu/sumcheck/prover.py): per round the univariate's
coefficients, the challenge r = MimcHash(coefficients), then a fold of
every table at r.

Round selection follows the reference's kernel path
(gkr_mimc_tpu/sumcheck/prover.py:217-228, 276-437), by gate:

* a cipher gate over 2 tables with one claim runs Gruen-factored head
  rounds (suffix eq tables, ``ops.kernels.gruen_acc``, the unfused combine,
  the transcript hash, eq1, the fold of x0 and x1) while the tables are
  larger than 2**tail_bits;
* an identity gate over 1 table runs coefficient-form head rounds
  (``ops.kernels.identity_acc``) on the eq table of ``_make_eq``;
* everything else, and every table of at most 2**tail_bits entries, takes
  the generic evaluation-form round in plain torch field ops (the
  reference leaves these to XLA).

Every multi-claim layer builds its eq table with the single-pass hi/lo
contraction (``ops.kernels.multi_eq``). Transcripts do not depend on the
split: all paths compute the same round polynomial exactly.

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
    """coeffs (bn, deg+2, 8): round-k univariate in coefficient form;
    challenges (bn, 8); final_claims (k+1, 8) = [eq(challenges), X_0, ...].
    All canonical Montgomery rows."""

    coeffs: torch.Tensor
    challenges: torch.Tensor
    final_claims: torch.Tensor


def canon_rows(t: torch.Tensor) -> torch.Tensor:
    """Canonicalize limb-last rows."""
    return fr.canonicalize(t.movedim(-1, 0)).movedim(0, -1).contiguous()


def _col(t: torch.Tensor) -> torch.Tensor:
    """An (8,) element as an (8, 1) per-group scalar."""
    return t.reshape(L, 1).contiguous()


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


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------


def _stack_t(tables: torch.Tensor, n_evals: int) -> torch.Tensor:
    """(8, T, 2m) -> (8, T, n_evals, m): the restriction of each table to
    the leading variable at t = 0, 1, ..., n_evals - 1, by repeated adds
    of (top - bot)."""
    m = tables.shape[-1] // 2
    bot, top = tables[..., :m], tables[..., m:]
    d = fr.sub(top, bot)
    rows = [bot, top]
    for _ in range(n_evals - 2):
        rows.append(fr.add(rows[-1], d))
    return torch.stack(rows, dim=2)


def _generic_round(gate: Gate, params, eq, xs):
    """Evaluation-form round: evaluations at t = 0..deg+1, interpolation,
    challenge, plain folds. Returns (eq, xs, coeffs, r)."""
    n_evals = gate.degree + 2
    tables = torch.stack([eq] + list(xs), dim=1)  # (8, 1 + k, n)
    at_t = _stack_t(tables, n_evals)
    g = gate.eval_batch(params, list(at_t[:, 1:].unbind(1)))
    evals = fr.reduce_sum(fr.mul(at_t[:, 0], g), 1)  # (8, n_evals)
    coeffs = lagrange.interpolate_on_range_device(evals)
    r = mimc_hash_device(coeffs)
    folded = multilin.fold(tables, r).unbind(1)
    return folded[0], list(folded[1:]), coeffs, r


def _identity_round(eq, x):
    """Coefficient-form identity round (gkr_mimc_tpu/sumcheck/prover.py:
    416-437): P0..P2 from the kernel, challenge, fold of eq and x."""
    coeffs = K.identity_acc(eq, x, 1)[:, :, 0].contiguous()  # (8, 3)
    r = mimc_hash_device(coeffs)
    eq, x = K.fold([eq, x], _col(r))
    return eq, x, coeffs, r


def _suffix_tables(q: torch.Tensor, n_head: int) -> list:
    """[T_0 .. T_{n_head-1}]: T_k is the eq table over the variables
    k+1..bn-1 (MSB first), 2**(bn-1-k) entries, built back to front by
    suffix doubling steps."""
    bn = q.shape[0]
    t = fr.one((1,), q.device)
    out = {bn - 1: t}
    for j in range(bn - 1, 0, -1):
        t = K.suffix_step(t, _col(q[j]))
        out[j - 1] = t
    return [out[k] for k in range(n_head)]


def _eq1_at(qk, r):
    """eq1(q, r) = 1 - q - r + 2 q r."""
    one = fr.one((), qk.device)
    t = fr.mul(qk, r)
    return fr.add(fr.sub(fr.sub(one, qk), r), fr.add(t, t))


def _gruen_combine(qc, qk, ck):
    """Q (8, 8) -> P (8, 9): P_m = ck * (alpha Q_m + beta Q_{m-1}) with
    alpha = 1 - q_k, beta = 2 q_k - 1."""
    one = fr.one((), qk.device)
    alpha = fr.sub(one, qk)
    beta = fr.sub(fr.add(qk, qk), one)
    zero = fr.zeros((1,), qc.device)
    p = fr.add(
        torch.cat([fr.mul(qc, alpha.reshape(L, 1)), zero], dim=1),
        torch.cat([zero, fr.mul(qc, beta.reshape(L, 1))], dim=1),
    )
    return fr.mul(p, ck.reshape(L, 1))


def _gruen_head(params, xs, q, n_head, coeffs_out, rs_out):
    """Gruen-factored head rounds of a single-claim cipher layer
    (gkr_mimc_tpu/sumcheck/prover.py:332-398, unfused round stage):
    eq(q, (r_<k, t, y)) = c_k * eq1(q_k, t) * S_k[y], so each round
    contracts against the challenge-free suffix table S_k and only x0, x1
    fold. Returns the tail's eq table c_K * T_{K-1} and tables."""
    suffix = _suffix_tables(q, n_head)
    ark = _col(params[0])
    ck = fr.one((), q.device)
    x0, x1 = xs
    for k in range(n_head):
        qk = q[k]
        qc = K.gruen_acc(suffix[k], x0, x1, ark)[:, :, 0]  # (8, 8)
        coeffs = _gruen_combine(qc, qk, ck)
        r = mimc_hash_device(coeffs)
        ck = fr.mul(ck, _eq1_at(qk, r))
        x0, x1 = K.fold([x0, x1], _col(r))
        coeffs_out.append(coeffs)
        rs_out.append(r)
    return fr.mul(suffix[n_head - 1], ck.reshape(L, 1)), [x0, x1]


def _kernel_kind(gate: Gate, xs) -> str | None:
    if isinstance(gate, CipherGate) and len(xs) == 2:
        return "cipher"
    if isinstance(gate, IdentityGate) and len(xs) == 1:
        return "identity"
    return None


def prove(xs: list, qprimes: torch.Tensor, claims, gate: Gate,
          tail_bits: int = TAIL_BITS, lo_bits: int = LO_BITS) -> SumcheckProof:
    """xs: tables (8, 2**bn); qprimes: (J, bn, 8) evaluation points; claims:
    (8, J) claimed values (used only for the Fiat-Shamir RLC), or None for
    the output layer (then J = 1)."""
    j, bn = qprimes.shape[0], qprimes.shape[1]
    device = qprimes.device
    for x in xs:
        if tuple(x.shape) != (L, 1 << bn):
            raise ValueError(f"table shape {tuple(x.shape)}, expected (8, {1 << bn})")
    if claims is None:
        if j != 1:
            raise ValueError("a layer without claims takes exactly one qPrime")
        claims = fr.zeros((0,), device)
    params = gate.params(device)
    kind = _kernel_kind(gate, xs)
    coeffs, rs = [], []
    xs = list(xs)
    if kind == "cipher" and j == 1 and bn > tail_bits:
        eq, xs = _gruen_head(params, xs, qprimes[0], bn - tail_bits, coeffs, rs)
    else:
        eq = _make_eq(qprimes, claims, lo_bits)
        while kind == "identity" and eq.shape[-1] > 1 << tail_bits:
            eq, x, c, r = _identity_round(eq, xs[0])
            xs = [x]
            coeffs.append(c)
            rs.append(r)
    while eq.shape[-1] > 1:
        eq, xs, c, r = _generic_round(gate, params, eq, xs)
        coeffs.append(c)
        rs.append(r)

    final = canon_rows(torch.stack([eq[:, 0]] + [x[:, 0] for x in xs], dim=0))
    n_evals = gate.degree + 2
    if coeffs:
        proof = canon_rows(torch.stack(coeffs, dim=0).transpose(1, 2))
        chals = canon_rows(torch.stack(rs, dim=0))
    else:
        proof = torch.zeros((0, n_evals, L), dtype=torch.int32, device=device)
        chals = torch.zeros((0, L), dtype=torch.int32, device=device)
    return SumcheckProof(coeffs=proof, challenges=chals, final_claims=final)
