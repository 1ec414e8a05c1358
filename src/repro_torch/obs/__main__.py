"""``python -m repro_torch.obs <file>`` — summarize (and convert) obs traces.

Typical use::

    REPRO_OBS=run.jsonl PYTHONPATH=src python -m repro_torch.quickstart
    PYTHONPATH=src python -m repro_torch.obs run.jsonl    # text summary
    PYTHONPATH=src python -m repro_torch.obs run.jsonl \
        --perfetto run.trace.json     # open in https://ui.perfetto.dev

Accepts either on-disk form (JSONL or Chrome/Perfetto trace_event
JSON) — the format is sniffed, so a ``.trace.json`` produced by
``--perfetto`` can itself be summarized.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import (read_records, summarize, write_jsonl,
                              write_trace_events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize an obs trace (JSONL or trace_event "
                    "JSON) and optionally convert between the two "
                    "formats.")
    ap.add_argument("file", help="trace file (JSONL or trace_event)")
    ap.add_argument("--perfetto", metavar="OUT", default=None,
                    help="also write a Chrome/Perfetto trace_event "
                         "JSON file (open in chrome://tracing or "
                         "ui.perfetto.dev)")
    ap.add_argument("--jsonl", metavar="OUT", default=None,
                    help="also write the records back out as JSONL "
                         "(trace_event → JSONL conversion)")
    ap.add_argument("--top", type=int, default=20,
                    help="rows per summary table (default 20)")
    args = ap.parse_args(argv)

    try:
        records = read_records(args.file)
    except (OSError, ValueError) as e:
        print(f"error: cannot read {args.file}: {e}", file=sys.stderr)
        return 1
    print(summarize(records, top=args.top))
    if args.perfetto:
        write_trace_events(records, args.perfetto)
        print(f"\nwrote {args.perfetto} (open in ui.perfetto.dev)")
    if args.jsonl:
        write_jsonl(records, args.jsonl)
        print(f"wrote {args.jsonl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
