"""witness_ms: the witness layer's mean time a proof, in ms: the benchmark's
synchronised host-clock span around the Montgomery conversion and the
witness call (``models/mimc.py`` or ``models/checkpoint.py``), over every
proof of the window."""


def read(record: dict):
    spans = [p["witness_s"] for p in record["proofs"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
