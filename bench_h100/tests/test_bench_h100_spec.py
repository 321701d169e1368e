"""BENCHMARK.json against its contract's shape, and every file it names found."""

import json
import re

import pytest

from bench_h100 import rooflines
from bench_h100.spec import HERE, ROOT, Cell, load, quantity, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = Cell(BENCH, workload)
    assert cell.workload["chips"] == 1 and len(cell.workload["why"]) <= 200
    assert cell.config["reduced"] == [] and cell.traffic["mode"] in ("single", "grouped")
    assert {quantity(m["name"]) for m in cell.end_to_end} == {"setup_s", "hashes_per_s"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(reader(m["name"])) and m["moves"] in e2e


def test_names_units_and_metric_entries():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_h100/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_files_under_paths_are_named_from_name_characters():
    for path in HERE.rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or "_cache" in rel or path.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_roofline_bytes_at_small_shapes():
    # bn 10, tail 8: head rounds k = 0, 1 on 2^10 and 2^9 entries
    n, e = 1 << 10, 32
    cipher = 2 * e * ((n + n // 2) + (n // 2 + n // 4))
    identity = 1 * e * ((n + n // 2) + (n // 2 + n // 4))
    want = 93 * e * n + 91 * cipher + identity
    assert rooflines.proof_bytes(10, 1, 8) == want
    assert rooflines.proof_bytes(10, 4, 8) == 4 * want  # G lanes: every table G times longer
    assert rooflines.proof_bytes(8, 1, 8) == 93 * e * (1 << 8)  # no head round: the witness alone
    assert rooflines.proof_seconds(10) == pytest.approx(want / 3.35e12)
