"""Structured findings shared by every analysis layer (the reference's
``repro.analysis.findings``, copied: the JSON is byte-equal).

A finding is one violated invariant: which pass raised it, how bad it is,
the offending op (or source line, for lint), the byte payload when the
pass is about data movement, and a hint that tells the reader what the
sanctioned alternative is.  All three layers (graph passes, race checker,
lint) emit these, so the CLI and CI render one table.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Sequence

#: Finding severities, worst first.  ``error`` fails the CLI/CI gate;
#: ``warning`` is reported but does not gate; ``note`` is informational
#: (e.g. a config the graph passes cannot trace yet).
SEVERITIES = ("error", "warning", "note")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant, as ``{pass, severity, op, bytes, hint}``."""

    pass_name: str
    severity: str
    op: str
    hint: str
    bytes: int = 0
    where: str = ""
    step: str = ""

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}"
            )

    def to_json(self) -> Dict[str, Any]:
        return {
            "pass": self.pass_name,
            "severity": self.severity,
            "op": self.op,
            "bytes": self.bytes,
            "hint": self.hint,
            "where": self.where,
            "step": self.step,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Finding":
        return Finding(
            pass_name=str(d["pass"]),
            severity=str(d["severity"]),
            op=str(d["op"]),
            hint=str(d.get("hint", "")),
            bytes=int(d.get("bytes", 0)),
            where=str(d.get("where", "")),
            step=str(d.get("step", "")),
        )

    def format(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        stp = f" [{self.step}]" if self.step else ""
        byt = f" ({self.bytes} B)" if self.bytes else ""
        return (
            f"{self.severity.upper():7s} {self.pass_name}{stp}: "
            f"{self.op}{byt}{loc}\n        hint: {self.hint}"
        )


def errors(findings: Iterable[Finding]) -> List[Finding]:
    """The gate-failing subset."""
    return [f for f in findings if f.severity == "error"]


def render(findings: Sequence[Finding]) -> str:
    """Human-readable report, worst findings first."""
    if not findings:
        return "no findings"
    order = {s: i for i, s in enumerate(SEVERITIES)}
    ranked = sorted(findings, key=lambda f: (order[f.severity], f.pass_name))
    lines = [f.format() for f in ranked]
    n_err = len(errors(findings))
    lines.append(f"{len(findings)} finding(s), {n_err} error(s)")
    return "\n".join(lines)


def dump_json(findings: Sequence[Finding], path: str) -> str:
    """Write findings as a JSON list (the nightly CI upload format)."""
    with open(path, "w") as f:
        json.dump([x.to_json() for x in findings], f, indent=2, sort_keys=True)
        f.write("\n")
    return path
