"""The port's command-line tools on the CPU: ``scripts/trace_tool_torch.py``
over a trace a replica of the port dumped, and ``scripts/fuzz_torch.py``
running one trajectory under a time box and refusing the tensor-parallel
engine."""
import importlib.util
import json
import pathlib

import pytest

from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.obs import Tracer, dump_trace
from repro_torch.serve import EngineConfig, Replica, Request

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    """The trace of 3 requests served by the qwen3 smoke model's overlapped
    window engine on the CPU, one slot's KV poisoned mid-run."""
    cfg = smoke_config("qwen3-1.7b")
    tracer = Tracer()
    rep = Replica(cfg, Model(cfg, device="cpu", seed=0),
                  config=EngineConfig(window=4, num_slots=2, max_len=32),
                  tracer=tracer)
    for i, prompt in enumerate(((5, 6, 7), (9, 10), (11, 12, 13, 14))):
        assert rep.submit(Request(id=i, prompt=prompt, max_new_tokens=6)) is None
    cycles, poisoned = 0, False
    while not rep.idle():
        busy = [s.idx for s in rep.sched.slots if s.active and s.generated]
        if cycles >= 2 and busy and not poisoned:
            rep.inject_state_fault(busy[0])
            poisoned = True
        rep.step()
        cycles += 1
        assert cycles < 200
    assert poisoned
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    dump_trace(str(path), tracer)
    return path


def test_trace_tool_checks_and_reports(trace_path, capsys, tmp_path):
    tool = _script("trace_tool_torch")
    assert tool.main([str(trace_path), "--check"]) == 0
    assert "OK" in capsys.readouterr().out
    assert tool.main([str(trace_path), "--faults"]) == 0
    assert "NONFINITE_LOSS" in capsys.readouterr().out
    assert tool.main([str(trace_path)]) == 0
    # a trace whose requests never reach their terminal span fails the check
    trace = json.loads(trace_path.read_text())
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if (e.get("cat"), e.get("name")) != ("request", "request")]
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(trace))
    assert tool.main([str(broken), "--check"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_fuzz_cli_runs_one_trajectory_on_the_cpu(tmp_path, capsys):
    fuzz = _script("fuzz_torch")
    report = tmp_path / "report.json"
    assert fuzz.main(["--device", "cpu", "--budget", "1", "--engines", "stepwise",
                      "--no-promote", "--time-box", "60",
                      "--db", str(tmp_path / "db.json"),
                      "--report", str(report)]) == 0
    rep = json.loads(report.read_text())
    assert rep["ran"] == 1 and not rep["counterexamples"]
    assert "fuzz: ran 1/1" in capsys.readouterr().out
    with pytest.raises(SystemExit) as refused:
        fuzz.main(["--device", "cpu", "--budget", "1", "--engines", "overlap_tp"])
    assert refused.value.code == 2
    assert "ROADMAP Queue 1, item 11" in capsys.readouterr().err
