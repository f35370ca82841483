"""thriftlint orchestration for the port: walk → rules → suppressions →
report (the JAX package's ``analysis/linter.py``, over ``repro_torch``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .findings import (
    Finding,
    Suppression,
    apply_suppressions,
    parse_suppressions,
)
from .rules import ALL_RULES
from .walker import Project

# the source root that holds this package
SRC = Path(__file__).resolve().parents[2]


@dataclass
class LintReport:
    findings: list[Finding]            # surviving (incl. bad-suppression)
    suppressed: list[Finding]          # silenced by a reasoned inline comment
    suppressions: list[Suppression]
    rules_run: tuple[str, ...]
    files_scanned: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_rule(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def suppressed_by_rule(self) -> dict[str, int]:
        """How many findings each rule's reasoned suppressions silenced."""
        out: dict[str, int] = {}
        for f in self.suppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "rules": list(self.rules_run),
            "files_scanned": self.files_scanned,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "suppressed_by_rule": self.suppressed_by_rule(),
        }


@dataclass
class Linter:
    src_root: Path = SRC
    package: str = "repro_torch"
    rules: tuple[str, ...] = ()
    _project: Project | None = field(default=None, repr=False)

    @property
    def project(self) -> Project:
        if self._project is None:
            self._project = Project(self.src_root, self.package)
        return self._project

    def run(self) -> LintReport:
        project = self.project
        names = self.rules or tuple(ALL_RULES)
        unknown = [n for n in names if n not in ALL_RULES]
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; known: {sorted(ALL_RULES)}"
            )
        raw: list[Finding] = []
        for name in names:
            raw.extend(ALL_RULES[name](project))

        suppressions: list[Suppression] = []
        for mod in project.modules.values():
            suppressions.extend(parse_suppressions(mod.path, mod.text))
        surviving, suppressed = apply_suppressions(raw, suppressions)
        return LintReport(
            findings=surviving,
            suppressed=suppressed,
            suppressions=suppressions,
            rules_run=names,
            files_scanned=len(project.modules),
        )


def run_lint(
    src_root: str | Path = SRC,
    package: str = "repro_torch",
    rules: tuple[str, ...] = (),
) -> LintReport:
    return Linter(Path(src_root), package, tuple(rules)).run()
