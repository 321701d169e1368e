"""peak_gib: the device memory one proof needs, in GiB: the largest rise of
``torch.cuda.max_memory_allocated()`` over what was allocated as a proof
began (the peak statistics reset there), plus that proof's own inputs.
What the benchmark holds beside it (the inputs of later proofs, the
outputs kept for the check) is left out, so the number is what a prover
serving one batch at a time needs."""


def read(record: dict):
    rises = [p["peak_above_start_bytes"] for p in record["proofs"]]
    if not rises or max(rises) <= 0:
        return None
    return (max(rises) + record["inputs_bytes"]) / 2**30
