"""The port's entry points against the JAX package's, in process:
``python -m repro_torch.launch.serve`` against ``repro.launch.serve`` and
``python -m repro_torch.quickstart`` against ``examples/quickstart.py``.

The serve CLI runs at ``--qps 0`` (admission by size, never by the clock)
with one and four replicas, faults, drift and probes; every printed line
must be the reference's once the clocked fields (wall time, qps, p50/p99)
are taken out — accuracy, mean cost, planes, flushes, groups, plan
counters, stragglers, the replica, fault and online-loop lines. The
quickstart prints the reference's output exactly, at small sizes. Without
``--device`` the serve CLI runs on the card, and with no card it fails.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch

import repro.launch.serve as j_serve
import repro_torch.launch.serve as t_serve
import repro_torch.quickstart as t_quickstart
from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)

ROOT = Path(__file__).resolve().parents[1]
CLOCKED = re.compile(r" in [0-9.]+s \([0-9]+ qps\) \| p50 [0-9.]+ms p99 [0-9.]+ms")
SMALL = ["--queries", "200", "--history", "600"]


def _ref_serve(argv, monkeypatch, capsys):
    monkeypatch.delenv("REPRO_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    return capsys.readouterr().out


def _time_free(out):
    lines = [CLOCKED.sub("", line) for line in out.strip().splitlines()]
    assert lines[0].startswith("served ") and " qps" not in lines[0]
    return lines


@pytest.mark.parametrize("argv", [
    ["--replicas", "1", "--fault-rate", "0.1", "--drift-after", "100", "--probe-rate", "0.02"],
    ["--replicas", "4", "--fault-rate", "0.1", "--drift-after", "100", "--probe-rate", "0.02"],
    ["--replicas", "4", "--fault-rate", "0.2", "--fault-arms", "0,3,5"],
], ids=["r1-online", "r4-online", "r4-faults-only"])
def test_serve_cli_prints_the_reference_lines(argv, monkeypatch, capsys):
    want = _time_free(_ref_serve(SMALL + argv, monkeypatch, capsys))
    t_serve.main(SMALL + argv + ["--device", "cpu"])
    got = _time_free(capsys.readouterr().out)
    assert got == want
    replicas = int(argv[argv.index("--replicas") + 1])
    assert any(line.startswith("replica plane: R=4 on 1 device(s) [fused]")
               for line in got) == (replicas == 4)
    assert any(line.startswith("fault plane:") for line in got)
    assert any(line.startswith("online loop:") for line in got) == ("--drift-after" in argv)


def test_serve_cli_defaults_to_the_card(capsys):
    """No ``--device``: the router is on the card. Without one, the CLI
    fails rather than falling back to the CPU."""
    argv = ["--queries", "16", "--history", "300"]
    if torch.cuda.is_available():
        t_serve.main(argv)
        assert capsys.readouterr().out.startswith("served 16 queries")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            t_serve.main(argv)


def test_quickstart_prints_the_reference_output(capsys):
    spec = importlib.util.spec_from_file_location("quickstart_ref",
                                                  ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    argv = ["--queries", "80", "--history", "300"]
    ref.main(argv)
    want = capsys.readouterr().out
    t_quickstart.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "pool costs" in got and "ThriftLLM=" in got
