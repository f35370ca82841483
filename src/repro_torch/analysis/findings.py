"""Finding model and the inline-suppression grammar for the port's thriftlint.

A copy of the JAX package's ``analysis/findings.py`` (the same grammar, so
one comment silences a finding under either linter).

A finding is one violation of one rule at one source location.  The only
sanctioned way to silence a true-but-intentional finding is an inline
comment on the flagged line:

    # thriftlint: ignore[rule-name] why this is safe here

The reason text is mandatory — a bare ``ignore[rule]`` is itself reported
as a ``bad-suppression`` finding, and ``bad-suppression`` cannot be
suppressed.  There is no file- or config-level allowlist on purpose: every
exemption must sit next to the code it exempts, with its justification,
where the next editor will see both.
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field


# matches `<tool>: ignore[rule-a,rule-b] reason text` comments, where the
# tool name is spelled out to avoid this very pattern self-matching docs
_SUPPRESS_RE = re.compile(
    r"#\s*thriftlint:\s*ignore\[(?P<rules>[a-z0-9,\-\s]*)\]\s*(?P<reason>.*)$"
)

# Rule id for malformed suppressions; not suppressible by design.
BAD_SUPPRESSION = "bad-suppression"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str            # repo-relative path
    line: int            # 1-indexed, matches the suppression comment line
    message: str
    symbol: str = ""     # qualified function name when known

    def format(self) -> str:
        where = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}{sym}: {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
        }


@dataclass
class Suppression:
    """A parsed ``# thriftlint: ignore[...]`` comment."""

    path: str
    line: int
    rules: tuple[str, ...]
    reason: str
    used_by: list[Finding] = field(default_factory=list)

    @property
    def has_reason(self) -> bool:
        return bool(self.reason.strip())

    def covers(self, finding: Finding) -> bool:
        if finding.rule == BAD_SUPPRESSION:
            return False
        if finding.path != self.path or finding.line != self.line:
            return False
        return finding.rule in self.rules or "*" in self.rules


def parse_suppressions(path: str, text: str) -> list[Suppression]:
    """Extract every suppression comment in ``text`` (one per line max).

    Real COMMENT tokens only — the same spelling inside a docstring or
    string literal (e.g. the examples in this module) is not a
    suppression.
    """
    out: list[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m is None:
            continue
        lineno = tok.start[0]
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        out.append(
            Suppression(
                path=path,
                line=lineno,
                rules=rules,
                reason=m.group("reason").strip(),
            )
        )
    return out


def apply_suppressions(
    findings: list[Finding], suppressions: list[Suppression]
) -> tuple[list[Finding], list[Finding]]:
    """Split ``findings`` into (surviving, suppressed).

    Malformed suppressions (no rule list, or no reason) are appended to the
    surviving list as ``bad-suppression`` findings — a silencing comment
    that does not say *why* is itself a contract violation.
    """
    by_loc: dict[tuple[str, int], list[Suppression]] = {}
    for s in suppressions:
        by_loc.setdefault((s.path, s.line), []).append(s)

    surviving: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        hit = None
        for s in by_loc.get((f.path, f.line), ()):
            if s.covers(f) and s.has_reason:
                hit = s
                break
        if hit is not None:
            hit.used_by.append(f)
            suppressed.append(f)
        else:
            surviving.append(f)

    for s in suppressions:
        if not s.rules:
            surviving.append(
                Finding(
                    rule=BAD_SUPPRESSION,
                    path=s.path,
                    line=s.line,
                    message="suppression lists no rules: use "
                    "`# thriftlint: ignore[rule] reason`",
                )
            )
        elif not s.has_reason:
            surviving.append(
                Finding(
                    rule=BAD_SUPPRESSION,
                    path=s.path,
                    line=s.line,
                    message=f"suppression of {list(s.rules)} gives no "
                    "reason — the justification is mandatory",
                )
            )
    surviving.sort(key=lambda f: (f.path, f.line, f.rule))
    return surviving, suppressed
