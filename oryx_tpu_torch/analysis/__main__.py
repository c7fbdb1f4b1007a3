"""``python -m oryx_tpu_torch.analysis`` — run the static analysis suite.

Exit status: 0 = clean (no unsuppressed findings), 1 = findings, 2 =
usage error.  ``--json`` emits the machine-readable report consumed
by the golden-output test, so its shape is a stable contract
(docs/ANALYSIS.md "Report shape").
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from .core import (PASS_NAMES, SourceModel, apply_suppressions,
                   load_suppressions, run_passes)

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent


def _default_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m oryx_tpu_torch.analysis",
        description="oryx-lint: concurrency-aware static analysis")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASS_NAMES, metavar="NAME",
                    help="run only this pass (repeatable); default: "
                         "all of " + ", ".join(PASS_NAMES))
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--root", type=pathlib.Path,
                    default=_default_root(),
                    help="package root to scan (default: oryx_tpu_torch)")
    ap.add_argument("--conf", type=pathlib.Path, default=None,
                    help="reference.conf for the drift pass "
                         "(default: <root>/common/reference.conf)")
    ap.add_argument("--doc", type=pathlib.Path, default=None,
                    help="RESILIENCE.md for the drift pass "
                         "(default: the repo's docs/RESILIENCE.md)")
    ap.add_argument("--suppressions", type=pathlib.Path,
                    default=pathlib.Path(__file__).parent
                    / "suppressions.toml",
                    help="suppression ledger (TOML)")
    ap.add_argument("--no-suppressions", action="store_true",
                    help="report everything, ledger ignored")
    args = ap.parse_args(argv)

    root = args.root.resolve()
    if not root.is_dir():
        print(f"error: --root {root} is not a directory",
              file=sys.stderr)
        return 2
    conf = args.conf if args.conf is not None else \
        root / "common" / "reference.conf"
    if args.doc is not None:
        doc = args.doc
    else:
        doc = _REPO / "docs" / "RESILIENCE.md"
        local = root.parent / "RESILIENCE.md"
        if not doc.is_file() and local.is_file():
            doc = local

    t0 = time.monotonic()
    model = SourceModel(root, conf_path=conf, doc_path=doc)
    findings = run_passes(model, args.passes)
    suppressions = []
    if not args.no_suppressions and args.suppressions.is_file():
        suppressions = load_suppressions(args.suppressions)
        apply_suppressions(findings, suppressions)
    elapsed = time.monotonic() - t0

    open_findings = [f for f in findings if not f.suppressed]
    if args.json:
        report = {
            "version": 1,
            "passes": list(args.passes or PASS_NAMES),
            "root": root.name,
            "findings": [f.to_dict() for f in findings],
            "counts": {
                "total": len(findings),
                "suppressed": len(findings) - len(open_findings),
                "open": len(open_findings),
            },
        }
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for f in findings:
            tag = " [suppressed]" if f.suppressed else ""
            print(f"{f.file}:{f.line}: [{f.pass_name}/{f.rule}] "
                  f"{f.symbol}: {f.message}{tag}")
        stale = [s for s in suppressions if s.hits == 0]
        for s in stale:
            print(f"note: stale suppression (matched nothing): "
                  f"pass={s.pass_name} file={s.file} "
                  f"symbol={s.symbol}", file=sys.stderr)
        print(f"{len(findings)} finding(s), "
              f"{len(findings) - len(open_findings)} suppressed, "
              f"{len(open_findings)} open; "
              f"{len(model.modules)} modules in {elapsed:.2f}s",
              file=sys.stderr)
    return 1 if open_findings else 0


if __name__ == "__main__":
    sys.exit(main())
