"""Lint findings and the report artifact the lint gate archives.

Port of ``repro.analysis.report``. A ``Finding`` is one named defect (or
advisory) from one pass; the ``LintReport`` aggregates them per arch,
mirrors counts into the port's ``obs.REGISTRY`` (``lint_findings_total``
by check and severity), and serializes to the schema-v1 ``report.json``
that ``python -m repro_torch.obs.validate --lint`` checks (the
reference's key set, ``sort_keys`` and ``indent=2``)."""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

from repro_torch import obs

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    """One defect: which pass raised it, how bad, where, and why.

    Only ``error`` findings gate (nonzero CLI exit); ``warning`` is
    advisory (e.g. donation reads that may be stale by design) and
    ``info`` is coverage commentary."""

    check: str                 # activation_width | dispatch | ...
    severity: str              # error | warning | info
    message: str
    path: str = ""             # leaf path / plan key / layer, if known
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "check": self.check,
            "severity": self.severity,
            "message": self.message,
            "path": self.path,
            "detail": self.detail,
        }


@dataclasses.dataclass
class LintReport:
    """All passes' findings for one arch, plus the pass-1 evidence."""

    arch: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    kv_bits: Dict[str, int] = dataclasses.field(default_factory=dict)
    kv_bounds: Dict[str, float] = dataclasses.field(default_factory=dict)
    passes: List[str] = dataclasses.field(default_factory=list)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def clean(self) -> bool:
        return not self.errors

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            key = f"{f.check}/{f.severity}"
            out[key] = out.get(key, 0) + 1
        return out

    def mirror_to_obs(self) -> Dict[str, int]:
        """One ``lint_findings_total`` increment per finding, labeled by
        check and severity: serving and training telemetry consumers see
        lint results through the same registry as every other counter."""
        counter = obs.REGISTRY.counter(
            "lint_findings_total",
            "Static-analysis lint findings by check and severity.",
        )
        for f in self.findings:
            counter.inc(1, check=f.check, severity=f.severity)
        return self.counts()

    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "arch": self.arch,
            "clean": self.clean,
            "passes": list(self.passes),
            "findings": [f.to_jsonable() for f in self.findings],
            "counters": self.counts(),
            "kv_bits": {k: int(v) for k, v in sorted(self.kv_bits.items())},
            "kv_bounds": {k: float(v)
                          for k, v in sorted(self.kv_bounds.items())},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, indent=2, sort_keys=True)
            f.write("\n")
