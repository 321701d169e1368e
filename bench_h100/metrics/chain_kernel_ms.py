"""chain_kernel_ms: device ms a proof in the transcript's hash-chain kernels
(their names are in ``chain_kernel_ms.json``), summed over the traced
window's device events and divided by the proofs traced."""

import json
from pathlib import Path

CHAIN = tuple(json.loads(Path(__file__).with_suffix(".json").read_text())["kernels"])


def is_chain(name: str) -> bool:
    return any(k in name for k in CHAIN)


def read(record: dict):
    trace = record.get("trace")
    if not trace or not trace["proofs"] or not trace["device"]:
        return None
    return sum(d for name, _, d in trace["device"] if is_chain(name)) / 1e3 / trace["proofs"]
