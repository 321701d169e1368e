"""Groth16 over BN254 with the GKR gadget's split-K modification, on the
host (the counterpart of gkr_mimc_tpu/gadget/groth16.py, itself the
analog of the reference's gnark fork, prover/gadget/{setup,prove,verify}.go).

  * ``setup``: the CRS from toxic scalars (from ``os.urandom``, or from a
    seed for the deterministic DummySetup flavour), plus the gadget's
    K-split {pubKGkr, privKGkrSigma (sigma-marked), privKNotGkr} and
    deltaSigmaInvNeg.
  * ``prove``: computeH (the NTT quotient) and the Groth16 MSMs with the K
    multiexp split: the GKR part arrives precomputed from the commitment
    step, the privKNotGkr part is added here.
  * ``verify``: rho re-derived from the io commitment, then the 4-term
    pairing check e(KrsPub, -gamma) e(Krs, -delta) e(KrsGkrPriv,
    -delta/sigma) e(Ar, Bs) == e(alpha, beta).

Every batch (the fixed-base key batches, the MSMs, computeH) runs in the
native runtime (``native``), which raises ``NativeBuildError`` when it
cannot build: no path drops to Python. The pure-Python versions are the
``*_plain`` functions below, the tests' oracles. Pairings run in pure
Python (``pairing``), once per verification.
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass

from .. import native
from ..snark.r1cs import CompiledR1CS
from . import bn254_g1 as g1
from . import bn254_g2 as g2
from . import pairing as pr
from .keccak import keccak256

R = g1.R


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


@dataclass
class Groth16ProvingKey:
    alpha1: tuple
    beta1: tuple
    delta1: tuple
    beta2: tuple
    delta2: tuple
    a_query: list  # [u_i(tau)]1 per wire
    b1_query: list  # [v_i(tau)]1 per wire
    b2_query: list  # [v_i(tau)]2 per wire
    z_query: list  # [tau^j * t(tau) / delta]1, j < d - 1
    # the gadget's K-split
    priv_k_not_gkr: list
    priv_k_gkr_sigma: list
    priv_not_gkr_wires: list  # canonical wire ids aligned with priv_k_not_gkr
    priv_gkr_wires: list


@dataclass
class Groth16VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    k_pub: list  # [(beta u + alpha v + w) / gamma]1 per public wire, wire 0 included
    delta_sigma_inv_neg: tuple  # sigma^-1 * (-delta) in G2
    pub_k_gkr: list
    pub_gkr_wires: list
    pub_not_gkr_wires: list  # wire 0 excluded


@dataclass
class GadgetGroth16Proof:
    """The Groth16 proof and the GKR commitment's extras."""

    ar: tuple
    bs: tuple  # G2
    krs: tuple
    krs_gkr_priv: tuple
    initial_randomness: int


class Groth16VerifyError(Exception):
    pass


# ---------------------------------------------------------------------------
# Batches: the native runtime on the path, pure Python by name
# ---------------------------------------------------------------------------


def _g1_batch(scalars: list[int]) -> list:
    return native.batch_scalar_mul(g1.to_jac(g1.GEN), scalars)


def _g2_batch(scalars: list[int]) -> list:
    return native.batch_scalar_mul_g2(g2.to_jac(g2.GEN), scalars)


def compute_h(a: list[int], b: list[int], c: list[int], d: int) -> list[int]:
    """h(X) = (A(X) B(X) - C(X)) / (X^d - 1) coefficients (prove.go's
    computeH, on the coset g = 5), in the native runtime."""
    return native.compute_h(a, b, c, d)


def g1_batch_plain(scalars: list[int]) -> list:
    gen = g1.to_jac(g1.GEN)
    return [g1.scalar_mul(gen, s) for s in scalars]


def g2_batch_plain(scalars: list[int]) -> list:
    gen = g2.to_jac(g2.GEN)
    return [g2.scalar_mul(gen, s) for s in scalars]


def msm_plain(points, scalars) -> tuple:
    acc = g1.INF
    for p, s in zip(points, scalars):
        if s % R:
            acc = g1.add(acc, g1.scalar_mul(p, s))
    return acc


def msm_g2_plain(points, scalars) -> tuple:
    acc = g2.INF
    for p, s in zip(points, scalars):
        if s % R:
            acc = g2.add(acc, g2.scalar_mul(p, s))
    return acc


def _ntt(vals: list[int], omega: int) -> list[int]:
    n = len(vals)
    a = list(vals)
    j = 0
    for i in range(1, n):  # bit reversal
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j ^= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(omega, n // length, R)
        for i in range(0, n, length):
            wcur = 1
            for k in range(length // 2):
                x = a[i + k]
                y = a[i + k + length // 2] * wcur % R
                a[i + k] = (x + y) % R
                a[i + k + length // 2] = (x - y) % R
                wcur = wcur * wlen % R
        length *= 2
    return a


def compute_h_plain(a: list[int], b: list[int], c: list[int], d: int) -> list[int]:
    """``compute_h`` by a pure-Python NTT."""
    omega = pow(5, (R - 1) // d, R)
    omega_inv = pow(omega, R - 2, R)
    d_inv = pow(d, R - 2, R)
    g = 5
    g_inv = pow(g, R - 2, R)

    def intt(v):
        return [x * d_inv % R for x in _ntt(v, omega_inv)]

    def coset(v, gg):
        acc, out = 1, []
        for x in v:
            out.append(x * acc % R)
            acc = acc * gg % R
        return out

    A = _ntt(coset(intt(a + [0] * (d - len(a))), g), omega)
    B = _ntt(coset(intt(b + [0] * (d - len(b))), g), omega)
    C = _ntt(coset(intt(c + [0] * (d - len(c))), g), omega)
    zinv = pow((pow(g, d, R) - 1) % R, R - 2, R)
    H = [(x * y - z) % R * zinv % R for x, y, z in zip(A, B, C)]
    return coset(intt(H), g_inv)


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _toxic(seed: bytes, tag: bytes) -> int:
    v = int.from_bytes(keccak256(seed + b":" + tag), "big") % R
    return v or 1


def _batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one modexp for n inverses."""
    n = len(xs)
    pref = [1] * (n + 1)
    for i, x in enumerate(xs):
        pref[i + 1] = pref[i] * x % R
    inv_all = pow(pref[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = pref[i] * inv_all % R
        inv_all = inv_all * xs[i] % R
    return out


def _domain_size(n: int) -> int:
    d = 1
    while d < max(n, 2):
        d *= 2
    return d


def setup(r1cs: CompiledR1CS, gkr_partition, seed: bytes | None = None):
    """The CRS from toxic waste (alpha, beta, gamma, delta, tau, sigma):
    from ``os.urandom`` when seed is None (the reference's Setup), from
    ``seed`` otherwise (its DummySetup). ``gkr_partition`` is the wire split
    (pub_gkr, priv_gkr, pub_not_gkr, priv_not_gkr) made at compile time
    (``incircuit.GadgetCircuit.compile``). -> (pk, vk)."""
    if seed is None:
        seed = os.urandom(32)
    alpha, beta, gamma, delta, tau, sigma = (
        _toxic(seed, tag) for tag in (b"alpha", b"beta", b"gamma", b"delta", b"tau", b"sigma"))

    ncons = len(r1cs.constraints)
    d = _domain_size(ncons)
    omega = pow(5, (R - 1) // d, R)

    # L_c(tau) over the omega-domain through one batched inversion
    zt = (pow(tau, d, R) - 1) % R
    omega_pows = [1] * ncons
    for c in range(1, ncons):
        omega_pows[c] = omega_pows[c - 1] * omega % R
    dinvs = _batch_inv([d * (tau - w) % R for w in omega_pows])
    lag = [zt * w % R * iv % R for w, iv in zip(omega_pows, dinvs)]

    # u_i(tau), v_i(tau), w_i(tau) per wire
    nw = r1cs.n_wires
    u, v, w = [0] * nw, [0] * nw, [0] * nw
    for c, (A, B, C) in enumerate(r1cs.constraints):
        lc_tau = lag[c]
        for wire, coeff in A:
            u[wire] = (u[wire] + coeff * lc_tau) % R
        for wire, coeff in B:
            v[wire] = (v[wire] + coeff * lc_tau) % R
        for wire, coeff in C:
            w[wire] = (w[wire] + coeff * lc_tau) % R

    ginv = pow(gamma, R - 2, R)
    dinv = pow(delta, R - 2, R)
    k_all = [(beta * u[i] + alpha * v[i] + w[i]) % R for i in range(nw)]
    n_pub = r1cs.n_public + 1  # wire 0 included
    k_pub_scalars = [k_all[i] * ginv % R for i in range(n_pub)]
    k_priv_scalars = [k_all[i] * dinv % R for i in range(n_pub, nw)]

    z_scalars = []  # tau^j * t(tau) / delta
    acc = zt * dinv % R
    for _ in range(d - 1):
        z_scalars.append(acc)
        acc = acc * tau % R

    pub_gkr, priv_gkr, pub_not_gkr, priv_not_gkr = gkr_partition
    sigma_scaled = [k_priv_scalars[wid - n_pub] * sigma % R for wid in priv_gkr]
    not_gkr_scaled = [k_priv_scalars[wid - n_pub] for wid in priv_not_gkr]
    # the fixed-base batches are independent and the native calls release
    # the interpreter lock: overlap them on threads (setup.go's Parallelize)
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        f_a = ex.submit(_g1_batch, u)
        f_b1 = ex.submit(_g1_batch, v)
        f_b2 = ex.submit(_g2_batch, v)
        f_kp = ex.submit(_g1_batch, k_pub_scalars)
        f_z = ex.submit(_g1_batch, z_scalars)
        f_sig = ex.submit(_g1_batch, sigma_scaled)
        f_ng = ex.submit(_g1_batch, not_gkr_scaled)
        a_query, b1_query, b2_query = f_a.result(), f_b1.result(), f_b2.result()
        k_pub_pts, z_query = f_kp.result(), f_z.result()
        priv_k_gkr_sigma, priv_k_not_gkr = f_sig.result(), f_ng.result()

    gen1, gen2 = g1.to_jac(g1.GEN), g2.to_jac(g2.GEN)
    delta2 = g2.scalar_mul(gen2, delta)
    delta_sigma_inv_neg = g2.scalar_mul(g2.neg(delta2), pow(sigma, R - 2, R))
    pk = Groth16ProvingKey(
        alpha1=g1.scalar_mul(gen1, alpha),
        beta1=g1.scalar_mul(gen1, beta),
        delta1=g1.scalar_mul(gen1, delta),
        beta2=g2.scalar_mul(gen2, beta),
        delta2=delta2,
        a_query=a_query,
        b1_query=b1_query,
        b2_query=b2_query,
        z_query=z_query,
        priv_k_not_gkr=priv_k_not_gkr,
        priv_k_gkr_sigma=priv_k_gkr_sigma,
        priv_not_gkr_wires=list(priv_not_gkr),
        priv_gkr_wires=list(priv_gkr),
    )
    vk = Groth16VerifyingKey(
        alpha1=pk.alpha1,
        beta2=pk.beta2,
        gamma2=g2.scalar_mul(gen2, gamma),
        delta2=delta2,
        k_pub=k_pub_pts,
        delta_sigma_inv_neg=delta_sigma_inv_neg,
        pub_k_gkr=[k_pub_pts[wid] for wid in pub_gkr],
        pub_gkr_wires=list(pub_gkr),
        pub_not_gkr_wires=list(pub_not_gkr),
    )
    return pk, vk


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------


def prove(r1cs: CompiledR1CS, pk: Groth16ProvingKey, krs_gkr_priv: tuple, initial_randomness: int,
          seed: bytes | None = None) -> GadgetGroth16Proof:
    """The Groth16 proof with the K multiexp split: the sigma-marked GKR
    commitment arrives as ``krs_gkr_priv`` (the commitment step's), the
    privKNotGkr part is added here, and Krs otherwise carries only Z/H and
    the r/s blinding. The blinding is fresh per proof (``os.urandom``)
    unless a seed is given."""
    z = r1cs.wires
    a_vals = [x[0] for x in r1cs.abc]
    b_vals = [x[1] for x in r1cs.abc]
    c_vals = [x[2] for x in r1cs.abc]
    d = _domain_size(len(r1cs.constraints))
    if seed is None:
        seed = os.urandom(32)
    r_blind = _toxic(seed, b"r")
    s_blind = _toxic(seed, b"s")

    # computeH and the three large multiexps are independent: overlap them
    # (prove.go's goroutine per MSM)
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        f_h = ex.submit(compute_h, a_vals, b_vals, c_vals, d)
        f_a = ex.submit(native.msm, pk.a_query, z)
        f_b1 = ex.submit(native.msm, pk.b1_query, z)
        f_b2 = ex.submit(native.msm_g2, pk.b2_query, z)
        h = f_h.result()
        f_krs = ex.submit(native.msm, pk.z_query, h[: d - 1])
        ar_j = g1.add(g1.add(pk.alpha1, f_a.result()), g1.scalar_mul(pk.delta1, r_blind))
        bs1_j = g1.add(g1.add(pk.beta1, f_b1.result()), g1.scalar_mul(pk.delta1, s_blind))
        bs2_j = g2.add(g2.add(pk.beta2, f_b2.result()), g2.scalar_mul(pk.delta2, s_blind))
        krs_j = f_krs.result()
    krs_j = g1.add(krs_j, g1.scalar_mul(ar_j, s_blind))
    krs_j = g1.add(krs_j, g1.scalar_mul(bs1_j, r_blind))
    krs_j = g1.add(krs_j, g1.scalar_mul(pk.delta1, (R - r_blind * s_blind % R) % R))
    # + the private K part outside the GKR ios
    krs_j = g1.add(krs_j, native.msm(pk.priv_k_not_gkr, [z[wid] for wid in pk.priv_not_gkr_wires]))
    return GadgetGroth16Proof(ar=ar_j, bs=bs2_j, krs=krs_j, krs_gkr_priv=krs_gkr_priv,
                              initial_randomness=initial_randomness)


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------


def verify(proof: GadgetGroth16Proof, vk: Groth16VerifyingKey, public_values: list[int]) -> None:
    """Raise ``Groth16VerifyError`` unless the proof holds. public_values
    are the public wires' values in canonical order (wire 1.., that is
    [rho, the inner circuit's publics...])."""
    if proof.initial_randomness == 0:
        raise Groth16VerifyError("initial randomness missing from the proof")
    if len(public_values) != len(vk.k_pub) - 1:
        raise Groth16VerifyError(f"expected {len(vk.k_pub) - 1} public inputs, got {len(public_values)}")
    z_pub = [1] + [v % R for v in public_values]

    # KrsGkr from the public ios and the proof's private part; rho again
    krs_gkr_pub = native.msm(vk.pub_k_gkr, [z_pub[wid] for wid in vk.pub_gkr_wires])
    rho = g1.derive_randomness_from_point(g1.add(krs_gkr_pub, proof.krs_gkr_priv))
    if rho != proof.initial_randomness:
        raise Groth16VerifyError("the initial randomness does not match the io commitment")

    # KrsPub = sum over all public wires of z_w * K_w
    krs_pub = native.msm(vk.k_pub, z_pub)
    ok = pr.pairing_check([
        (krs_pub, g2.neg(vk.gamma2)),
        (proof.krs, g2.neg(vk.delta2)),
        (proof.krs_gkr_priv, vk.delta_sigma_inv_neg),
        (proof.ar, proof.bs),
        (g1.neg(vk.alpha1), vk.beta2),
    ])
    if not ok:
        raise Groth16VerifyError("the pairing check failed")
