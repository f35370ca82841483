"""The port's thriftlint (``repro_torch.analysis``) and its parity with the
JAX package's (``repro.analysis``).

* **fixtures** — each port rule fires exactly on the seeded violations of
  ``tests/lint_fixtures/badtorch/`` (and the global-RNG ban on
  ``badrng/``), located by their ``FIRES: <rule>`` markers, and nowhere
  else; the two rules both linters have fire as often on ``badtorch`` as
  the reference's do on ``badrepro``, file for translated file;
* **parity** — both packages parse suppressions alike on every fixture and
  port file, and their walkers agree on modules, functions and call sites;
* **real tree** — ``src/repro_torch`` has zero findings, every suppression
  is reasoned, and every function the reference's walker reaches in
  ``core``/``serving`` is reachable in the port when the port has it;
* **CLI** — ``python -m repro_torch.analysis``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import findings as jfindings
from repro.analysis import run_lint as jrun_lint
from repro.analysis.walker import Project as JProject
from repro_torch.analysis import ALL_RULES, BAD_SUPPRESSION, Project, run_lint
from repro_torch.analysis import findings as tfindings
from repro_torch.analysis.walker import DEVICE_ROOTS

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"
SHARED_RULES = ("prng-discipline", "f64-reduction")
# badrepro's file -> its translation in badtorch
TRANSLATED = {"core/keys.py": "core/keys.py", "core/reductions.py": "core/reductions.py"}


def _expected_locations(package: str, rule: str) -> set[tuple[str, int]]:
    """(path, line) pairs of ``package`` carrying a ``FIRES: <rule>`` marker."""
    out = set()
    for path in (FIXTURES / package).rglob("*.py"):
        rel = path.relative_to(FIXTURES).as_posix()
        for lineno, line in enumerate(path.read_text().splitlines(), start=1):
            if f"FIRES: {rule}" in line:
                out.add((rel, lineno))
    return out


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC)}


class TestRulesFireOnFixtures:
    @pytest.mark.parametrize("rule", sorted(ALL_RULES))
    def test_rule_fires_exactly_on_seeded_violations(self, rule):
        report = run_lint(src_root=FIXTURES, package="badtorch", rules=(rule,))
        expected = _expected_locations("badtorch", rule)
        assert expected, f"fixture tree seeds no {rule} violations"
        assert {(f.path, f.line) for f in report.findings} == expected
        assert all(f.rule == rule for f in report.findings)

    @pytest.mark.parametrize("package", ["badtorch", "badrng"])
    def test_all_rules_marker_census(self, package):
        """Every finding is a marked line and vice versa."""
        report = run_lint(src_root=FIXTURES, package=package)
        expected = set()
        for rule in ALL_RULES:
            expected |= _expected_locations(package, rule)
        assert {(f.path, f.line) for f in report.findings} == expected

    def test_global_rng_ban_fires_exactly_on_seeded_violations(self):
        report = run_lint(src_root=FIXTURES, package="badrng", rules=("prng-discipline",))
        expected = _expected_locations("badrng", "prng-discipline")
        assert len(expected) == 8
        assert {(f.path, f.line) for f in report.findings} == expected

    @pytest.mark.parametrize("rule", SHARED_RULES)
    def test_shared_rules_fire_as_often_as_the_reference(self, rule):
        port = run_lint(src_root=FIXTURES, package="badtorch", rules=(rule,))
        ref = jrun_lint(src_root=FIXTURES, package="badrepro", rules=(rule,))
        assert len(port.findings) == len(ref.findings) > 0
        for jfile, tfile in TRANSLATED.items():
            n_ref = sum(f.path == f"badrepro/{jfile}" for f in ref.findings)
            n_port = sum(f.path == f"badtorch/{tfile}" for f in port.findings)
            assert n_port == n_ref, (jfile, n_ref, n_port)


def _fixture_and_port_files():
    return sorted(FIXTURES.rglob("*.py")) + sorted((SRC / "repro_torch").rglob("*.py"))


class TestParity:
    @pytest.mark.parametrize("path", _fixture_and_port_files(),
                             ids=lambda p: p.relative_to(REPO).as_posix())
    def test_suppression_parsing_matches_reference(self, path):
        text = path.read_text()
        rel = path.relative_to(REPO).as_posix()
        js = jfindings.parse_suppressions(rel, text)
        ts = tfindings.parse_suppressions(rel, text)
        key = lambda s: (s.path, s.line, s.rules, s.reason, s.has_reason)
        assert [key(s) for s in ts] == [key(s) for s in js]
        # every suppression applied to a finding of each of its rules on its line
        probe = lambda mod: [
            mod.Finding(rule=r, path=rel, line=s.line, message="probe")
            for s in (ts if mod is tfindings else js) for r in (*s.rules, "other-rule")
        ]
        got = tfindings.apply_suppressions(probe(tfindings), ts)
        want = jfindings.apply_suppressions(probe(jfindings), js)
        as_keys = lambda fs: [(f.rule, f.path, f.line, f.message) for f in fs]
        assert [as_keys(x) for x in got] == [as_keys(x) for x in want]

    @pytest.mark.parametrize("src,package", [
        (SRC, "repro_torch"), (FIXTURES, "badtorch"), (FIXTURES, "badrng"),
        (FIXTURES, "supptorch"), (FIXTURES, "badrepro"),
    ])
    def test_walker_matches_reference(self, src, package):
        port, ref = Project(src, package), JProject(src, package)
        assert list(port.modules) == list(ref.modules)
        for name, mod in port.modules.items():
            rmod = ref.modules[name]
            assert mod.path == rmod.path
            assert list(mod.scan.functions) == list(rmod.scan.functions)
            assert mod.scan.imports == rmod.scan.imports
            site = lambda c: (c.node.lineno, c.node.col_offset, c.loop_depth,
                              c.enclosing.qualname if c.enclosing else None)
            assert [site(c) for c in mod.scan.calls] == [site(c) for c in rmod.scan.calls]

    def test_suppression_grammar_edge_cases(self):
        for text in ('"""docs say # thriftlint: ignore[f64-reduction] reason"""\nx = 1\n',
                     "x = 1  # thriftlint: ignore[bad-suppression]\n",
                     "x = 1  # thriftlint: ignore[] why\n",
                     "x = 1  # thriftlint: ignore[a, b]   spaced reason  \n"):
            js = jfindings.parse_suppressions("m.py", text)
            ts = tfindings.parse_suppressions("m.py", text)
            assert [(s.line, s.rules, s.reason) for s in ts] == [
                (s.line, s.rules, s.reason) for s in js]
            surviving, suppressed = tfindings.apply_suppressions([], ts)
            jsurv, jsupp = jfindings.apply_suppressions([], js)
            assert [f.format() for f in surviving] == [f.format() for f in jsurv]
            assert suppressed == jsupp == []


class TestSuppressionMachinery:
    def test_reasoned_reasonless_and_bare(self):
        report = run_lint(src_root=FIXTURES, package="supptorch")
        by_rule = report.by_rule()
        assert len(by_rule[BAD_SUPPRESSION]) == 1
        assert len(by_rule["f64-reduction"]) == 2
        assert len(report.suppressed) == 1
        assert report.suppressed[0].rule == "f64-reduction"
        assert report.suppressed_by_rule() == {"f64-reduction": 1}


@pytest.fixture(scope="module")
def project():
    return Project(SRC)


class TestRealTree:
    @pytest.mark.parametrize("rule", sorted(ALL_RULES))
    def test_rule_silent_on_real_tree(self, rule):
        report = run_lint(src_root=SRC, rules=(rule,))
        assert [f.format() for f in report.findings] == []

    def test_full_run_is_clean_and_suppressions_are_reasoned(self):
        report = run_lint(src_root=SRC)
        assert report.ok, [f.format() for f in report.findings]
        assert report.files_scanned == len(list((SRC / "repro_torch").rglob("*.py")))
        assert all(s.has_reason for s in report.suppressions)
        # every committed suppression silences something
        assert all(s.used_by for s in report.suppressions)

    def test_no_device_root_is_stale(self, project):
        assert project.stale_roots == []
        assert len(project.device_roots) == len(DEVICE_ROOTS)

    def test_reference_reachable_functions_are_reachable(self, project):
        """Every top-level function the reference's walker reaches in
        ``repro.core``/``repro.serving`` that the port has by module and
        name is device-reachable in the port."""
        ref = JProject(SRC)
        want = {
            (f.module.replace("repro.", "repro_torch.", 1), f.qualname)
            for f in ref.reachable
            if f.module.startswith(("repro.core", "repro.serving")) and "." not in f.qualname
        }
        have = {(f.module, f.qualname) for f in project.iter_functions()}
        reached = {(f.module, f.qualname) for f in project.reachable}
        ported = want & have
        assert len(ported) >= 13
        assert ported <= reached, sorted(ported - reached)
        # each DEVICE_ROOTS name is a reference jit entry point of that module
        entries = {(e.fn.module, e.fn.qualname) for e in ref.jit_entries if e.fn}
        for mod, name in DEVICE_ROOTS:
            assert (f"repro.{mod}", name) in entries

    def test_roots_of_each_kind(self, project):
        names = {f.qualname for f in project.reachable}
        assert {"KernelFunction.forward", "KernelFunction.backward"} <= {
            f.qualname for f in project.autograd_methods}
        # the callers of every kernel module's launch*
        callers = {s.enclosing.qualname for s in project.launch_sites}
        assert callers == {"belief_aggregate", "mc_correctness", "mc_correctness_grouped",
                           "_launch_flash", "_launch_rglru", "_launch_mamba", "_launch_conv"}
        assert len(project.launches) == 7
        assert {"_sur_greedy_scan_core.<locals>._pick", "_wave_scan_core",
                "_hist_from_ties", "fold_in"} <= names


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO, env=_env())


class TestCLI:
    def test_zero_findings_zero_exit(self):
        out = _cli()
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.startswith("thriftlint: 0 finding(s)")

    def test_json_report(self):
        out = _cli("--format=json")
        assert out.returncode == 0, out.stdout + out.stderr
        report = json.loads(out.stdout)
        assert report["ok"] and report["findings"] == []
        assert report["rules"] == list(ALL_RULES)
        assert report["suppressed_by_rule"] == {"f64-reduction": 1}

    def test_rule_listing(self):
        out = _cli("--list-rules")
        assert out.returncode == 0
        assert out.stdout.split() == list(ALL_RULES)

    def test_nonzero_exit_on_findings(self):
        out = _cli("--src", str(FIXTURES), "--package", "badtorch", "--rule", "tf32-off")
        assert out.returncode == 1
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("badtorch/")]
        assert len(lines) == 3 and all(": tf32-off [fast_matmuls]: " in ln for ln in lines)
        assert "thriftlint: 3 finding(s)" in out.stdout
