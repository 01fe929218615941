"""Validate ``--metrics-out`` JSONL streams and lint reports.

    python -m repro_torch.obs.validate metrics.jsonl [more.jsonl ...]
    python -m repro_torch.obs.validate --lint report.json [more.json ...]

Exits 1 when any stream is empty, malformed, off its mode's key set, or
fails the byte-accounting invariants. ``--lint`` switches to the
static-analysis report schema (``repro_torch.analysis.lint --out``
artifacts, and the reference's, which share it): the exact key set, the
finding shape, and internal consistency (``clean`` against the error
findings, ``counters`` against a recount). The checks live in
``obs.schema``, so that tests and this command agree.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.schema import validate_lint_report, validate_metrics_jsonl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+", metavar="PATH")
    ap.add_argument("--lint", action="store_true",
                    help="validate lint report JSON artifacts instead of "
                         "metrics JSONL streams")
    args = ap.parse_args(argv)

    failed = 0
    for path in args.paths:
        if args.lint:
            counts, errors = validate_lint_report(path)
            status = "OK" if not errors else "FAIL"
            print(f"{path}: {status} — {counts['findings']} findings "
                  f"({counts['errors']} errors, {counts['warnings']} "
                  f"warnings, {counts['infos']} infos)")
        else:
            counts, errors = validate_metrics_jsonl(path)
            status = "OK" if not errors else "FAIL"
            print(f"{path}: {status} — {counts['records']} records "
                  f"({counts['spans']} spans, {counts['events']} events, "
                  f"{counts['metrics_events']} metrics events)")
        for err in errors:
            print(f"  {err}", file=sys.stderr)
        failed += bool(errors)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
