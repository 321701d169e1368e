"""launches_per_proof: kernel launches a proof, counted as the traced
window's device kernel events (copies and sets left out) over the proofs
traced. The eager field ops of the round glue (``fields/fr.py`` on CUDA
tensors) make most of them."""

from bench_h100.trace import is_kernel


def read(record: dict):
    trace = record.get("trace")
    if not trace or not trace["proofs"] or not trace["device"]:
        return None
    return sum(1 for name, _, _ in trace["device"] if is_kernel(name)) / trace["proofs"]
