"""Replay a simulation seed: the failing-seed repro entry point.

    python -m oryx_tpu_torch.sim --scenario mirror-partition --seed 1234
    python -m oryx_tpu_torch.sim --scenario reshard-cutover --seed 7 --trace

Same seed, same trace — the run either reports the identical
invariant violation a sweep found, or prints the result summary and
trace hash.  ``--trace`` dumps every scheduler decision (step |
virtual time | event) for bisecting where the histories of a good
and a bad seed diverge.
"""

from __future__ import annotations

import argparse
import json
import sys

from .scenarios import SCENARIOS, SimFailure, run_scenario


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m oryx_tpu_torch.sim",
        description="deterministically replay a cluster-simulation "
                    "seed")
    ap.add_argument("--scenario", required=True,
                    choices=sorted(SCENARIOS))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--trace", action="store_true",
                    help="dump the full scheduler decision trace")
    args = ap.parse_args(argv)
    try:
        res = run_scenario(args.scenario, args.seed,
                           keep_trace=args.trace)
    except SimFailure as e:
        print(f"FAIL {e}", file=sys.stderr)
        return 1
    if args.trace and res.trace is not None:
        for line in res.trace:
            print(line)
    print(json.dumps({
        "scenario": res.scenario, "seed": res.seed,
        "trace_hash": res.trace_hash, "steps": res.steps,
        "virtual_sec": round(res.virtual_sec, 3),
        "stats": res.stats, "summary": res.summary,
    }, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
