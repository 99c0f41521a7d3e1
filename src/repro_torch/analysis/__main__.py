"""CLI of the port's static checks.

    python -m repro_torch.analysis                  # summary; exit 1 on any
                                                    # unsuppressed violation
    python -m repro_torch.analysis --json report.json
    python -m repro_torch.analysis --lint-only / --contracts-only
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import run_analysis


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract checker (fake-tensor runs) + AST lint for the port's "
                    "registered hot entry points",
    )
    p.add_argument("--json", metavar="PATH",
                   help="write the full JSON report to PATH ('-' for stdout)")
    p.add_argument("--lint-only", action="store_true",
                   help="run only the AST lint pass (no entry runs)")
    p.add_argument("--contracts-only", action="store_true",
                   help="run only the contract rules")
    args = p.parse_args(argv)
    if args.lint_only and args.contracts_only:
        p.error("--lint-only and --contracts-only are mutually exclusive")

    report = run_analysis(include_contracts=not args.lint_only,
                          include_lint=not args.contracts_only)
    if args.json == "-":
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    s = report["summary"]
    print(f"analysis: {s['rules']} rules, {s['entries_run']} entry points run, "
          f"{s['violations']} violations, {s['suppressed']} suppressed")
    for row in report["entries"]:
        print(f"  ran {row['entry']:44s} {row['violations']} violation(s)")
    for v in report["suppressed"]:
        print(f"  suppressed [{v['rule']}] {v['subject']}")
    for v in report["violations"]:
        print(f"  VIOLATION [{v['rule']}] {v['subject']}: {v['message']}")
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
