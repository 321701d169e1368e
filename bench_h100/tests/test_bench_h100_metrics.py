"""Each per-layer reader, and the trace arithmetic, on a small recorded trace."""

import json
from pathlib import Path

import pytest

from bench_h100 import trace
from bench_h100.spec import load, quantity, reader

RECORD = json.loads(Path(__file__).with_name("fixture_record.json").read_text())
EXPECTED = RECORD["expected"]


@pytest.mark.parametrize("metric", [m["name"] for m in load()["per_layer"]])
def test_reader_on_the_fixture(metric):
    assert reader(metric)(RECORD) == pytest.approx(EXPECTED[quantity(metric)], rel=1e-12)


def test_readers_find_nothing_without_a_trace():
    untraced = dict(RECORD, trace=None)
    for m in ("chain_kernel_ms", "table_hbm_roofline", "launches_per_proof", "device_idle_pct"):
        assert reader(m)(untraced) is None
    empty = dict(RECORD, trace=dict(RECORD["trace"], device=[]))
    assert reader("table_hbm_roofline")(empty) is None and reader("chain_kernel_ms")(empty) is None


def test_busy_gaps_and_breakdown():
    t = RECORD["trace"]
    assert trace.busy_us(t) / 1e6 == pytest.approx(EXPECTED["busy_s"])
    assert trace.idle_gaps(t) == [[600.0, 700.0], [850.0, 900.0], [950.0, 1000.0]]
    assert trace.gap_causes(t) == pytest.approx(EXPECTED["idle_gaps"])
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["(anonymous namespace)::gruen_round_kernel(int const*)", 300.0 / 1e6]
    assert len(b["device_ops"]) == 6 and b["idle_gaps"][0] == ["aten::mul", 100.0 / 1e6]
