"""thriftlint CLI for the port — static enforcement of its bitwise and
kernel contracts.

    python -m repro_torch.analysis                   # all rules over src/repro_torch
    python -m repro_torch.analysis --rule tf32-off --rule kernel-contract
    python -m repro_torch.analysis --format=json     # machine-readable report
    python -m repro_torch.analysis --list-rules

Exit status is non-zero when any finding survives — including
``bad-suppression`` findings for ``# thriftlint: ignore[...]`` comments
that omit a rule list or a reason.
"""
from __future__ import annotations

import argparse
import json

from . import ALL_RULES, run_lint
from .linter import SRC


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__.split("\n\n")[0]
    )
    parser.add_argument("--rule", action="append", default=[],
                        help="run only this rule (repeatable); default: all rules")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="output format")
    parser.add_argument("--src", default=str(SRC),
                        help="source root containing the package (default: src/)")
    parser.add_argument("--package", default="repro_torch",
                        help="package to scan (default: repro_torch)")
    parser.add_argument("--list-rules", action="store_true", help="list rule ids and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for name in ALL_RULES:
            print(name)
        return 0

    report = run_lint(src_root=args.src, package=args.package, rules=tuple(args.rule))
    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=2))
    else:
        for f in report.findings:
            print(f.format())
        reasoned = sum(1 for s in report.suppressions if s.has_reason)
        print(
            f"thriftlint: {len(report.findings)} finding(s), "
            f"{len(report.suppressed)} suppressed "
            f"({reasoned} reasoned suppression comment(s)), "
            f"{report.files_scanned} files, "
            f"rules: {', '.join(report.rules_run)}"
        )
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
