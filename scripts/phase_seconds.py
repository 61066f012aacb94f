#!/usr/bin/env python3
"""Sum the top-level phase seconds of ``chip_smoke.py`` runs and compare
them, phase by phase:

    python3 scripts/phase_seconds.py PARENT.log CHANGE.log [--min 1.0]

Reads the ``{"phase": "seconds", "of": ..., "seconds": ...}`` lines of each
log (``chip_smoke.py``'s standard output).  A family's serving phase times
its own runs inside it (``serve llama:float``, ``profile moe:float``, ...,
and ``temperature``); those are left out of the sum, as is ``build`` (the
kernels' compile).  A phase that runs more than once (``profile none``,
once through the graphs and once eagerly) counts each time.  Prints each
phase whose seconds differ by more than ``--min`` between the logs, the
phases that only one log has, and the two sums with the change's growth.
"""

from __future__ import annotations

import argparse
import json
import sys

# the families' own runs, timed inside their serving phase, and the
# structure variants', compression's and the new kinds' training runs,
# timed inside theirs
NESTED_TAGS = ("llama:", "gpt2:", "hybrid:", "mamba2:", "moe:", "deepseek:",
               "smollm:", "compress:", "structure:")


def top_level(name: str) -> bool:
    return not (name == "build" or name == "temperature"
                or any(tag in name for tag in NESTED_TAGS))


def phases(path: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for line in open(path, errors="replace"):
        if not line.startswith('{"phase": "seconds"'):
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if top_level(row["of"]):
            out[row["of"]] = out.get(row["of"], 0.0) + row["seconds"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--min", type=float, default=1.0)
    args = ap.parse_args(argv)
    a, b = phases(args.parent), phases(args.change)
    for name in list(a) + [n for n in b if n not in a]:
        pa, pb = a.get(name), b.get(name)
        if pa is None or pb is None or abs(pb - pa) > args.min:
            print(f"{name:45s} {pa if pa is not None else '-':>10} "
                  f"{pb if pb is not None else '-':>10}")
    sa, sb = sum(a.values()), sum(b.values())
    shared = sum(b[n] - a[n] for n in a if n in b)
    print(json.dumps({"parent_s": sa, "change_s": sb,
                      "growth": sb / sa - 1, "shared_phases_delta_s": shared,
                      "new_phases_s": sum(v for n, v in b.items()
                                          if n not in a),
                      "dropped_phases_s": sum(v for n, v in a.items()
                                              if n not in b)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
