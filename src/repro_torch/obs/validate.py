"""Validate Chrome trace-event JSON files.

Command-line front of ``repro_torch.obs.trace.validate_chrome_trace``
(the port's counterpart of ``scripts/validate_trace.py``): for each path,
loads the JSON and checks the invariants the exporter guarantees
(required keys per phase, time-sorted events, matched B/E spans,
truncation flagged). Exits non-zero if any file is missing, unparsable
or invalid.

Usage: PYTHONPATH=src python -m repro_torch.obs.validate TRACE.json ...
"""

from __future__ import annotations

import json
import sys

from repro_torch.obs.trace import validate_chrome_trace


def main(paths: list[str]) -> int:
    if not paths:
        print("usage: python -m repro_torch.obs.validate TRACE.json ...",
              file=sys.stderr)
        return 2
    failed = 0
    for path in paths:
        try:
            with open(path) as f:
                trace = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}")
            failed += 1
            continue
        errors = validate_chrome_trace(trace)
        if errors:
            failed += 1
            print(f"FAIL {path}: {len(errors)} problem(s)")
            for err in errors[:20]:
                print(f"  - {err}")
            if len(errors) > 20:
                print(f"  ... and {len(errors) - 20} more")
        else:
            n = len(trace.get("traceEvents", []))
            print(f"OK   {path}: {n} events")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
