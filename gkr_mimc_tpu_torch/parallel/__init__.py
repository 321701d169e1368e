"""The sharded GKR prover (the reference's gkr_mimc_tpu/parallel/).

``mesh.py`` splits the 2**bn hypercube cyclically over D processes, one
device each (global index x = q * D + d on rank d at local position q),
adds each round's sums over the ranks with an exact all-reduce of their
limbs, derives the same Fiat-Shamir challenge on every rank and folds
locally, so the proof is bit-equal to one device's. ``multihost.py`` brings
the process group up (explicitly or from torchrun's variables) and builds
each rank's slab of the inputs without the whole table.

The reference holds one global array sharded over a JAX mesh; torch has no
such array, so each rank holds its own slab and the reference's collectives
(``jax.lax.psum``, ``all_gather``) are ``torch.distributed`` calls.
"""
