"""nnslint: the port's contract-lint CLI (``nnstreamer_tpu_torch/analysis/lint.py``).

The port's counterpart of the JAX package's ``tools/nnslint.py``.  By
default it lints the port: ``nnstreamer_tpu_torch/`` of this checkout,
against the port's registry doc ``docs/torch-observability.md``, and gates
on findings that are not in the port's baseline
(``nnstreamer_tpu_torch/tools/nnslint_baseline.json``).  Every accepted
finding there carries its reason; one without a reason fails the run too.
AST only: it imports nothing it lints, so it runs on the CPU, on fixture
trees and on broken checkouts.

Usage::

    python -m nnstreamer_tpu_torch.tools.nnslint              # the port
    python -m nnstreamer_tpu_torch.tools.nnslint --root DIR   # another tree, whole
    python -m nnstreamer_tpu_torch.tools.nnslint --checks hooks,conf
    python -m nnstreamer_tpu_torch.tools.nnslint --no-baseline
    python -m nnstreamer_tpu_torch.tools.nnslint --write-baseline
    python -m nnstreamer_tpu_torch.tools.nnslint --format json

Exit codes: 0 clean (no new findings), 1 new findings or a baselined
finding without a reason, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..analysis import lint

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
PORT_PATHS = (os.path.basename(_PKG),)
PORT_DOCS = ("docs/torch-observability.md",)
PORT_BASELINE = os.path.join(_PKG, "tools", "nnslint_baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nnslint", description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="tree to lint whole, its .md files the docs (default: the "
                         "port's package against docs/torch-observability.md)")
    ap.add_argument("--checks", default="",
                    help=f"comma-separated subset of: {', '.join(lint.ALL_CHECKS)}")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the port's, or <root>/.nnslint-baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline: every finding fails the run")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings into the baseline (reasons kept)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-checks", action="store_true")
    args = ap.parse_args(argv)

    if args.list_checks:
        for c in lint.ALL_CHECKS:
            print(c)
        return 0

    if args.root is None:
        root, paths, docs = _REPO, PORT_PATHS, PORT_DOCS
        default_baseline = PORT_BASELINE
    else:
        root, paths, docs = os.path.abspath(args.root), None, None
        default_baseline = os.path.join(root, ".nnslint-baseline.json")
        if not os.path.isdir(root):
            print(f"nnslint: no such tree: {root}", file=sys.stderr)
            return 2
    checks = [c.strip() for c in args.checks.split(",") if c.strip()] or None
    try:
        findings = lint.run_checks(root, checks, paths=paths, docs=docs)
    except ValueError as exc:
        print(f"nnslint: {exc}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or default_baseline
    reasons = lint.load_reasons(baseline_path)
    if args.write_baseline:
        lint.write_baseline(baseline_path, findings, reasons)
        print(f"nnslint: wrote {len(findings)} accepted finding(s) to {baseline_path}")
        return 0

    baseline = set() if args.no_baseline else lint.load_baseline(baseline_path)
    new, resolved = lint.partition(findings, baseline)
    unreasoned = sorted(fp for fp in baseline if not str(reasons.get(fp, "")).strip())

    if args.format == "json":
        print(json.dumps({
            "findings": [dict(vars(f), fingerprint=f.fingerprint,
                              new=f.fingerprint not in baseline,
                              reason=reasons.get(f.fingerprint, ""))
                         for f in findings],
            "resolved_baseline": sorted(resolved),
            "unreasoned_baseline": unreasoned,
        }, indent=2))
    else:
        for f in findings:
            tag = "" if f.fingerprint not in baseline else \
                f" (baseline: {reasons.get(f.fingerprint, '') or 'NO REASON'})"
            print(f"{f}{tag}")
        if resolved:
            print(f"nnslint: {len(resolved)} baseline finding(s) no longer occur; "
                  "regenerate with --write-baseline:")
            for fp in sorted(resolved):
                print(f"  resolved: {fp}")
        for fp in unreasoned:
            print(f"nnslint: baselined without a reason: {fp}")
        print(f"nnslint: {len(findings)} finding(s), {len(new)} new, "
              f"{len(baseline & {f.fingerprint for f in findings})} baselined, "
              f"{len(resolved)} resolved")
    return 1 if new or unreasoned else 0


if __name__ == "__main__":
    sys.exit(main())
