"""The least device-memory traffic of one MiMC-91 GKR proof, from the
circuit's shapes alone, and the card's bandwidth.

    bytes = witness + sum over layers l, head rounds k of
            a_l * (E * N / 2^k)          (the input tables, read once)
          + a_l * (E * N / 2^(k + 1))    (the folded tables, written once)

    witness = (2 + 91) * E * N           (block and state read once, the 91
                                          round tables written once)

N is the instances a proof (G lanes x 2^bn), E = 32 bytes an element
(eight 32-bit words), a_l the tables a layer's sumcheck reads (2 for the
91 cipher layers, 1 for the identity layer). The head rounds are those on
tables of more than 2^tail_bits entries a lane, k = 0 .. bn - tail_bits - 1;
the tail rounds work on tables of at most 2^tail_bits entries, in on-chip
memory, and count nothing. The eq tables count nothing either (the Gruen
rounds keep them factored into small tables), so this is a lower bound of
what any implementation moves.

The time bound is bytes / 3.35e12 B/s, the H100 SXM's HBM3 bandwidth in
NVIDIA's data sheet (at the 700 W power limit; the run prints the card's
limit beside it).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = 32
MIMC_ROUNDS = 91
CIPHER_TABLES = 2  # a cipher layer's sumcheck reads the block copy and the round before
IDENTITY_TABLES = 1


def witness_bytes(bn: int, lanes: int = 1) -> int:
    n = lanes << bn
    return (2 + MIMC_ROUNDS) * ELEMENT_BYTES * n


def head_round_bytes(tables: int, bn: int, lanes: int, tail_bits: int) -> list[int]:
    """Bytes of each head round k of one layer whose sumcheck reads ``tables`` tables."""
    n = lanes << bn
    return [tables * ELEMENT_BYTES * ((n >> k) + (n >> (k + 1))) for k in range(max(bn - tail_bits, 0))]


def proof_bytes(bn: int, lanes: int = 1, tail_bits: int = 8) -> int:
    """The least bytes one proof moves: the witness and every head round."""
    cipher = sum(head_round_bytes(CIPHER_TABLES, bn, lanes, tail_bits))
    identity = sum(head_round_bytes(IDENTITY_TABLES, bn, lanes, tail_bits))
    return witness_bytes(bn, lanes) + MIMC_ROUNDS * cipher + identity


def proof_seconds(bn: int, lanes: int = 1, tail_bits: int = 8) -> float:
    return proof_bytes(bn, lanes, tail_bits) / HBM_BYTES_PER_S
