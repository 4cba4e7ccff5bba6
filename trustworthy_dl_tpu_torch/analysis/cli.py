"""``trustworthy-dl-torch-lint`` — run the port's invariant linter from
the shell (JAX's ``trustworthy-dl-lint``, over ``trustworthy_dl_tpu_torch/``
against ``tddl_torch_lint_baseline.json``).

Host-only by contract: this process never imports torch or jax (the
``import-purity`` rule lints this module's own import chain), so it runs
on machines without a card or a working CUDA install.

Exit codes: 0 clean (baselined findings and stale-baseline warnings do
not fail), 1 findings, 2 usage errors.

Usage::

    trustworthy-dl-torch-lint                    # the whole package
    trustworthy-dl-torch-lint trustworthy_dl_tpu_torch/serve
    trustworthy-dl-torch-lint --rules obs-emit-type,metric-prefix
    trustworthy-dl-torch-lint --format json      # machine-readable
    trustworthy-dl-torch-lint --write-baseline   # grandfather current
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from trustworthy_dl_tpu_torch.analysis import contracts
from trustworthy_dl_tpu_torch.analysis.baseline import write_baseline
from trustworthy_dl_tpu_torch.analysis.engine import repo_root, run_lint
from trustworthy_dl_tpu_torch.analysis.rules import all_rules


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="trustworthy-dl-torch-lint",
        description="AST-based invariant linter for the PyTorch/CUDA port "
                    "(rule catalog: README.md, the port's lint)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the package)")
    parser.add_argument(
        "--root", default=None,
        help="repo root paths are reported relative to (default: "
             "autodetected from the installed package)")
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated rule names to run (default: all)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    parser.add_argument(
        "--baseline", default=None,
        help=f"baseline file (default: <root>/{contracts.DEFAULT_BASELINE})")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report grandfathered findings too")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write current findings (pre-baseline) to the baseline "
             "file and exit 0; edit in the per-entry justifications")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="findings only, no summary line")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name:20s} {rule.description}")
        return 0

    root = os.path.abspath(args.root or repo_root())
    rule_names = None
    if args.rules:
        rule_names = [r.strip() for r in args.rules.split(",")
                      if r.strip()]
    paths = [os.path.abspath(p) for p in args.paths] or None

    baseline_path = args.baseline or os.path.join(
        root, contracts.DEFAULT_BASELINE)

    if args.write_baseline:
        if rule_names or paths:
            # A filtered run sees only a SUBSET of findings; writing it
            # wholesale would silently delete every other grandfathered
            # entry (and its hand-written justification).
            print("trustworthy-dl-torch-lint: error: --write-baseline "
                  "replaces the whole baseline and cannot be combined "
                  "with --rules or path arguments", file=sys.stderr)
            return 2
        result = run_lint(root=root, paths=paths, rule_names=rule_names,
                          use_baseline=False)
        write_baseline(result.findings, baseline_path)
        print(f"baseline: {len(result.findings)} finding(s) written to "
              f"{baseline_path} — add a real justification per entry")
        return 0

    try:
        result = run_lint(root=root, paths=paths, rule_names=rule_names,
                          baseline_path=baseline_path,
                          use_baseline=not args.no_baseline)
    except ValueError as exc:           # unknown rule, bad baseline
        print(f"trustworthy-dl-torch-lint: error: {exc}", file=sys.stderr)
        return 2

    if args.format == "json":
        payload = {
            "files_scanned": result.files_scanned,
            "findings": [f.as_dict() for f in result.findings],
            "baselined": result.baselined,
            "stale_baseline": result.stale_baseline,
            "by_rule": result.by_rule(),
            "clean": result.clean,
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        for f in result.findings:
            print(f"{f.location}: [{f.rule}] {f.message}")
        for entry in result.stale_baseline:
            print(f"stale baseline entry (matched nothing — delete "
                  f"it): [{entry['rule']}] {entry['path']}: "
                  f"{entry['message']}", file=sys.stderr)
        if not args.quiet:
            counts = ", ".join(f"{k}={v}"
                               for k, v in result.by_rule().items())
            print(f"{len(result.findings)} finding(s) in "
                  f"{result.files_scanned} file(s)"
                  + (f" [{counts}]" if counts else "")
                  + (f"; {result.baselined} baselined"
                     if result.baselined else ""))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
