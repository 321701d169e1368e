"""prove_ms: the GKR walk's mean time a proof, in ms: the synchronised span
around ``gkr.prover.prove`` (every layer's sumcheck, and for a
checkpointed witness the recomputation of its spans, which runs inside the
walk), over every proof of the window."""


def read(record: dict):
    spans = [p["prove_s"] for p in record["proofs"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
