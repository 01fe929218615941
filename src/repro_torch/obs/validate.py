"""Validate ``--metrics-out`` JSONL streams.

    python -m repro_torch.obs.validate metrics.jsonl [more.jsonl ...]

Exits 1 when any stream is empty, malformed, off its mode's key set, or
fails the byte-accounting invariants (``obs.schema``, where the checks
live so that tests and this command agree). ``--lint`` (the reference's
static-analysis report check) waits for the port of ``repro.analysis``
and exits 2 with a usage message.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.schema import validate_metrics_jsonl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+", metavar="PATH")
    ap.add_argument("--lint", action="store_true",
                    help="validate lint reports (not ported yet)")
    args = ap.parse_args(argv)
    if args.lint:
        ap.error("--lint checks the reports of repro.analysis, which the "
                 "port does not have yet (ROADMAP A14b, the analysis "
                 "slice); only metrics streams are validated")

    failed = 0
    for path in args.paths:
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
