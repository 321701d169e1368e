"""The port's checkpointed MiMC witness (gkr_mimc_tpu_torch/models/
checkpoint.py) on the CPU: its tables against the resident witness and the
JAX package's ``CheckpointedAssignment``, the walk's proof against the
resident walk's, and the guards against the reference's three defects
(ADVICE.md:3-5) and against rows kept as views of their span. Exact
comparisons.

    python -m pytest tests/test_torch_checkpoint.py -q -p no:cacheprovider
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.models.checkpoint import CheckpointedAssignment
from gkr_mimc_tpu_torch.models.mimc import assign_fused
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import from_jax_rows
from torch_common import mimc_instance


def inputs(bn, groups=None):
    """The JAX package's test inputs (tests/test_checkpoint.py): block the
    stream at 0, state the stream at 3; (8, G, N) with groups."""
    n = (1 << bn) * (groups or 1)
    block = fr.encode_mont_ints(random_fr_array(n))
    state = fr.encode_mont_ints(random_fr_array(n + 3)[3:])
    if groups:
        block, state = block.reshape(8, groups, -1), state.reshape(8, groups, -1)
    return block, state


def test_every_table_equals_the_resident_witness():
    block, state = inputs(6)
    full = assign_fused(block, state)
    ck = CheckpointedAssignment(block, state, stride=13)
    assert len(ck) == len(full) == 94
    for j in range(94):
        got = ck[j]
        assert got.device == block.device and fr.to_ints(got) == fr.to_ints(full[j]), j


def test_grouped_stride5_matches_jax():
    """(8, 2, 16) tables at stride 5 (19 spans, a single-row last one),
    the shape of the JAX package's test, against its CheckpointedAssignment."""
    from gkr_mimc_tpu.fields import fr as jfr
    from gkr_mimc_tpu.models.checkpoint import CheckpointedAssignment as JaxCheckpointed

    block, state = inputs(4, groups=2)
    jblock = jfr.from_ints_mont(random_fr_array(32)).reshape(jfr.L, 2, 16)
    jstate = jfr.from_ints_mont(random_fr_array(35)[3:]).reshape(jfr.L, 2, 16)
    ck, jck = CheckpointedAssignment(block, state, stride=5), JaxCheckpointed(jblock, jstate, stride=5)
    full = assign_fused(block, state)
    for j in (3, 7, 47, 92, 93):
        got = ck[j]
        assert got.shape == (8, 2, 16)
        want = from_jax_rows(np.asarray(jfr.canonicalize(jck[j])))
        assert torch.equal(fr.canonicalize(got), want), j
        assert torch.equal(fr.canonicalize(got), fr.canonicalize(full[j])), j


def test_walk_proof_equals_the_resident_walk():
    c, block, state, qprime = mimc_instance(3)
    resident = assign_fused(block, state)
    want = proof_to_vec(c, gkr_prover.prove(c, resident, qprime, tail_bits=2))
    ck = CheckpointedAssignment(block, state)
    proof = gkr_prover.prove(c, ck, qprime, tail_bits=2)
    assert proof_to_vec(c, proof) == want
    gkr_verifier.verify(c, proof, [block, state], ck[93], qprime)
    # every cipher table was read once: no span, checkpoint or marker is left
    assert ck._spans == [None] * ck.n_spans and ck._ckpt == [None] * ck.n_spans
    assert not ck._cache and ck._live == [0] * ck.n_spans


def test_second_read_of_a_consumed_table_raises():
    """ADVICE.md:3: the read names the table, its span and "single-use",
    also for a span whose checkpoint is long gone."""
    ck = CheckpointedAssignment(*inputs(3))
    ck[50]
    assert 50 not in ck._cache
    with pytest.raises(RuntimeError, match=r"table 50 \(span 3\).*single-use"):
        ck[50]
    ck[92]
    with pytest.raises(RuntimeError, match=r"table 92 \(span 6\).*single-use"):
        ck[92]


def test_single_row_last_span_keeps_no_buffer():
    """ADVICE.md:4: at stride 10 the last span is the output table alone
    (91 = 9 * 10 + 1); its buffer is not kept beside the pinned copy."""
    block, state = inputs(3)
    ck = CheckpointedAssignment(block, state, stride=10)
    assert ck.n_spans == 10 and ck._spans[-1] is None and ck._live[-1] == 0
    assert fr.to_ints(ck[93]) == fr.to_ints(assign_fused(block, state)[93])


def test_output_reads_leave_no_stale_markers():
    """ADVICE.md:5: the output table is pinned once, so reading it again
    (before, between and after the walk's reads) makes no span anew; once
    every cipher table is read, nothing keeps a span."""
    block, state = inputs(3)
    full = assign_fused(block, state)
    ck = CheckpointedAssignment(block, state)
    out = ck[93]
    for j in range(92, 2, -1):
        assert torch.equal(ck[93], out)
        assert fr.to_ints(ck[j]) == fr.to_ints(full[j])
    assert ck[93] is out and ck._live == [0] * ck.n_spans and ck._spans == [None] * ck.n_spans
    assert not ck._cache


def test_rows_are_copies_and_spans_are_freed():
    """torch's trap: a row kept as a view keeps its whole span alive. A
    span is freed as soon as its last row is handed out, even while the
    rows live; the output table's storage is one table's size."""
    block, state = inputs(4)
    ck = CheckpointedAssignment(block, state)
    table_bytes = 8 * 16 * 4
    assert ck[93].untyped_storage().nbytes() == table_bytes
    span = weakref.ref(ck._spans[-1])  # tables 81..92, made with the output
    rows = [ck[j] for j in range(92, 80, -1)]
    gc.collect()
    assert span() is None
    assert all(r.untyped_storage().nbytes() == table_bytes for r in rows)
    row = ck[80]  # span 5 made, one row handed out
    span5 = weakref.ref(ck._spans[5])
    del row
    gc.collect()
    assert span5() is not None  # twelve rows still to hand out
    for j in range(79, 67, -1):
        ck[j]
    gc.collect()
    assert span5() is None and ck._ckpt[5] is None
