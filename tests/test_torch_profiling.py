"""The port's timers and traces (gkr_mimc_tpu_torch/utils/profiling.py) on
the CPU: the reference's printed line and report shape, a Chrome trace
written by ``torch.profiler``, and GKR_PROFILE=0.

    python -m pytest tests/test_torch_profiling.py -q -p no:cacheprovider
"""

import io
import json
import re

import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_report():
    profiling.phase_report(reset=True)
    yield
    profiling.phase_report(reset=True)


def test_timer_prints_the_reference_line_and_syncs():
    out = io.StringIO()
    x = fr.one((4,))
    with profiling.Timer("witness", out=out) as t:
        y = t.sync_on([fr.add(x, x), {"k": (x,)}, "not a tensor"])
    assert y[0].shape == (8, 4)
    assert re.fullmatch(r"witness took \d+\.\d ms\n", out.getvalue())
    assert t.elapsed_ms > 0
    quiet = io.StringIO()
    with profiling.Timer("quiet", verbose=False, out=quiet):
        pass
    assert quiet.getvalue() == ""


def test_timed_and_phase_report_have_the_reference_shape(capsys):
    """The same phases through the JAX package's timers and the port's
    give reports of the same keys and counts."""
    from gkr_mimc_tpu.utils import profiling as jprofiling

    jprofiling.phase_report(reset=True)
    for mod in (profiling, jprofiling):
        for name in ("prove", "prove", "verify"):
            with mod.timed(name, verbose=False):
                pass
    got, want = profiling.phase_report(), jprofiling.phase_report(reset=True)
    assert set(got) == set(want) == {"prove", "verify"}
    for k in got:
        assert set(got[k]) == set(want[k]) == {"total_ms", "count", "mean_ms"}
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["mean_ms"] == pytest.approx(got[k]["total_ms"] / got[k]["count"])
    assert profiling.phase_report(reset=True) == got and profiling.phase_report() == {}
    with profiling.timed("printed"):
        pass
    assert "printed took" in capsys.readouterr().err


def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GKR_PROFILE", raising=False)
    with profiling.profile_trace("walk", root=str(tmp_path)) as path:
        fr.mul(fr.one((1 << 12,)), fr.one((1 << 12,)))
    assert path == str(tmp_path / "walk" / "trace.json")
    events = json.loads((tmp_path / "walk" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names), sorted(n for n in names if n)[:20]
    monkeypatch.chdir(tmp_path)
    with profiling.profile_trace("cwd") as path:
        torch.ones(3).sum()
    assert path == str(tmp_path / "profiling" / "cwd" / "trace.json")
    assert (tmp_path / "profiling" / "cwd" / "trace.json").exists()


def test_gkr_profile_0_turns_traces_off(tmp_path, monkeypatch):
    monkeypatch.setenv("GKR_PROFILE", "0")
    with profiling.profile_trace("off", root=str(tmp_path)) as path:
        torch.ones(3).sum()
    assert path is None and not (tmp_path / "off").exists()
