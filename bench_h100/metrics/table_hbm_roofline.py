"""table_hbm_roofline: the table passes' share of their HBM roofline, in %.

The least bytes a proof moves (``bench_h100/rooflines.py``: the witness
written once, every head round's tables read once and folded once) at
3.35 TB/s, over the device time a proof of every device operation that is
not a chain kernel (``chain_kernel_ms.json``). Nothing is read from the
program's own counts, so no implementation can read above 100 %; a change
that moves table work into a chain kernel needs the list corrected."""

from bench_h100.metrics.chain_kernel_ms import is_chain


def read(record: dict):
    trace = record.get("trace")
    if not trace or not trace["proofs"]:
        return None
    table_s = sum(d for name, _, d in trace["device"] if not is_chain(name)) / 1e6 / trace["proofs"]
    if table_s <= 0:
        return None
    return 100.0 * record["least_bytes_per_proof"] / record["hbm_bytes_per_s"] / table_s
