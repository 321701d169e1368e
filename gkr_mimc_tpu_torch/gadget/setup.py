"""Gadget key setup: the commitment keys of the GKR io multiexp and the
sigma marking of their private slice, the counterpart of
gkr_mimc_tpu/gadget/setup.py.

``dummy_setup`` is deterministic and ceremony-free: key i is h_i * G with
h_i = Keccak(seed || i) mod r, the private keys scalar-marked with sigma;
every key comes from the native runtime's fixed-base batch.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import native
from . import bn254_g1 as g1
from .keccak import keccak256


@dataclass
class GadgetSetup:
    """Commitment keys for the GKR io multiexp (setup.go:84-131)."""

    pub_k_gkr: list  # Jacobian points, one per public GKR io
    priv_k_gkr_sigma: list  # σ-marked points, one per private GKR io
    sigma: int  # toxic waste; kept only by dummy setups
    sigma_inv: int


def _hash_to_scalar(seed: bytes, i: int) -> int:
    return int.from_bytes(keccak256(seed + i.to_bytes(8, "big")), "big") % g1.R


def dummy_setup(n_pub: int, n_priv: int, seed: bytes = b"gkr-mimc-tpu") -> GadgetSetup:
    """Deterministic setup over `n_pub` public and `n_priv` private GKR io
    wires. Points are h_i·G with h_i = Keccak(seed‖i): unknown-dlog-free
    (fine for tests, same trust model as DummySetup's random DeltaNeg)."""
    gen = g1.to_jac(g1.GEN)
    sigma = _hash_to_scalar(seed, 0xFFFFFFFF) or 1
    h_pub = [_hash_to_scalar(seed + b"pub", i) for i in range(n_pub)]
    h_priv = [_hash_to_scalar(seed + b"priv", i) for i in range(n_priv)]
    # MarkWithSigma (setup.go:133-146): privKGkrSigma = σ·privKGkr; since
    # privKGkr_i = h_i·G the marked key is (σ·h_i mod r)·G — a fixed-base
    # batch, which the native runtime computes with one shared window table.
    h_priv_sigma = [sigma * h % g1.R for h in h_priv]

    pub = native.batch_scalar_mul(gen, h_pub) if h_pub else []
    priv_sigma = native.batch_scalar_mul(gen, h_priv_sigma) if h_priv_sigma else []
    return GadgetSetup(
        pub_k_gkr=pub,
        priv_k_gkr_sigma=priv_sigma,
        sigma=sigma,
        sigma_inv=pow(sigma, g1.R - 2, g1.R),
    )
