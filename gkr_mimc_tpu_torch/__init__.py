"""GKR prover for batched MiMC-91 hashes over BN254, and for the GMiMC and
Poseidon permutation circuits, in PyTorch with hand-written CUDA kernels
for the NVIDIA H100 (sm_90a).

This package is a port of ``gkr_mimc_tpu`` (JAX + Pallas on a TPU), which
stays beside it as the reference: on the same inputs both emit the same
round coefficients, Fiat-Shamir challenges, final claims and
``proof_to_vec`` wire vector. The port imports ``torch`` and numpy only,
never ``jax`` or ``gkr_mimc_tpu``: it carries its own field constants and
round constants.

Field layout (a deliberate deviation from the reference):

* A batch of field elements is an ``(8, *batch)`` ``torch.int32`` tensor
  holding the bit patterns of eight 32-bit limbs, limb-major, in
  Montgomery form with R = 2**256. The reference uses ``(16, *batch)``
  uint32 tensors of 16-bit limbs (``gkr_mimc_tpu/fields/fr.py``). Because
  R is the same, the Montgomery integer of an element is the same in both;
  only the limb split differs. 32 B per element instead of 64 B halves the
  witness (12.5 GB at 2**22 hashes), and ``torch.uint32`` has too few
  arithmetic ops to carry the field.
* Values are lazy representatives in [0, 2p): ``add`` and ``sub`` are
  exact arithmetic mod 2p, ``mul`` is a Montgomery REDC without the final
  subtraction. Proof artifacts are canonicalized to [0, p).
* Proof artifacts (coefficients, challenges, claims, evaluation points)
  are rows with the limb axis LAST, ``(..., 8)``, as in the reference.

``utils/convert.py`` converts between the two layouts.

Every Pallas kernel of the reference's ``ops/kernels.py`` has a CUDA
counterpart in ``csrc/`` (built at first use by ``ops/build.py``) and a
plain torch twin in ``ops/kernels.py``. A wrapper takes the plain twin
only for CPU tensors; a CUDA tensor goes to the kernel, or the wrapper
raises. ``ops/probes.py`` ports the reference's micro-benchmark scripts
(``scripts/micro_*.py``, ``scripts/check_mxu_mul.py``) as probe kernels
of the card's cost model for the field arithmetic, with an entry point
``python -m gkr_mimc_tpu_torch.ops.probes <script>``.
"""
