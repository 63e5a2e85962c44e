"""The port's lint:  python -m repro_torch.lint [options]

Two tiers (``--tier``):

* ``ast`` (default): the source-level rules (REP1xx-REP7xx); never
  imports the code under analysis.
* ``traced``: the REP8xx rules over the aten operations that real
  calls of the port issue on the CPU (``lint/traced``).  Needs torch.
* ``all``: both.

Exit codes: 0 clean (or fully baselined / allowed), 1 findings, 2
usage or internal error.  ``--format github`` emits workflow-command
annotations (``::error file=...``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.lint import LintReport, run_lint
from repro_torch.lint.baseline import (baseline_path, load_baseline,
                                 save_baseline)
from repro_torch.lint.rules import ALL_RULES

_TIERS = ("ast", "traced", "all")


def _github_escape(text: str) -> str:
    # workflow-command data: percent-encode the control characters
    return (text.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def _emit_github(report: LintReport) -> None:
    for f in report.findings:
        kind = "error" if f.severity == "error" else "warning"
        print(f"::{kind} file={_github_escape(f.path)},line={f.line},"
              f"col={f.col},title={f.rule}[{f.name}]::"
              f"{_github_escape(f.message)}")


def _emit_human(label: str, report: LintReport, unit: str) -> None:
    for f in report.findings:
        print(f.format())
    supp = []
    if report.suppressed_pragma:
        kind = "allowlisted" if label == "tracelint" else "pragma-disabled"
        supp.append(f"{report.suppressed_pragma} {kind}")
    if report.suppressed_baseline:
        supp.append(f"{report.suppressed_baseline} baselined")
    tail = f" ({', '.join(supp)})" if supp else ""
    if report.clean:
        print(f"{label}: clean — {report.n_modules} {unit}, "
              f"{len(report.rules_run)} rules{tail}")
    else:
        print(f"{label}: {len(report.findings)} finding(s) over "
              f"{report.n_modules} {unit}{tail}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static analysis of the port (kernel mirror, "
                    "determinism, dtype, host reads, shared memory, "
                    "reachability; recorded aten operations)")
    ap.add_argument("--root", default=".",
                    help="repo root to lint (default: cwd)")
    ap.add_argument("--tier", choices=_TIERS, default="ast",
                    help="analysis tier: ast (source rules), traced "
                         "(recorded operations, needs torch), or all")
    ap.add_argument("--format", choices=("human", "json", "github"),
                    default="human")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids/names to run "
                         "(default: all in the selected tier)")
    ap.add_argument("--baseline", default=None,
                    help="AST-tier baseline file (default: "
                         "<root>/.reprolint-torch.json)")
    ap.add_argument("--traced-baseline", default=None,
                    help="traced-tier baseline file (default: "
                         "<root>/.tracelint-torch.json)")
    ap.add_argument("--allowlist", default=None,
                    help="traced-tier allowlist file (default: "
                         "<root>/.tracelint-torch-allow.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report grandfathered findings too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the selected tier(s)' findings as the "
                         "new baseline(s) and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        rules = [cls() for cls in ALL_RULES]
        if args.tier in ("traced", "all"):
            from repro_torch.lint.traced.rules import TRACED_RULES
            traced = [cls() for cls in TRACED_RULES]
            rules = traced if args.tier == "traced" else rules + traced
        for r in rules:
            print(f"{r.id}  {r.name:<14} [{r.severity}] {r.description}")
        return 0

    root = Path(args.root).resolve()
    if not root.is_dir():
        print(f"error: --root {root} is not a directory", file=sys.stderr)
        return 2

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]

    skip_base = args.no_baseline or args.write_baseline
    reports: dict[str, LintReport] = {}
    try:
        if args.tier in ("ast", "all"):
            bpath = Path(args.baseline) if args.baseline else \
                baseline_path(root)
            base = {} if skip_base else load_baseline(bpath)
            reports["ast"] = run_lint(root, baseline=base,
                                      rule_ids=rule_ids)
            if args.write_baseline:
                counts = save_baseline(bpath, reports["ast"])
                print(f"wrote {bpath} ({sum(counts.values())} "
                      f"grandfathered finding(s) across {len(counts)} "
                      f"fingerprint(s))")
        if args.tier in ("traced", "all"):
            from repro_torch.lint.traced import (allowlist_path, load_allowlist,
                                           run_traced_lint,
                                           traced_baseline_path)
            tbpath = Path(args.traced_baseline) if args.traced_baseline \
                else traced_baseline_path(root)
            tbase = {} if skip_base else load_baseline(tbpath)
            apath = Path(args.allowlist) if args.allowlist else \
                allowlist_path(root)
            allow = load_allowlist(apath)
            reports["traced"] = run_traced_lint(
                root, rule_ids=rule_ids, baseline=tbase, allowlist=allow)
            if args.write_baseline:
                counts = save_baseline(tbpath, reports["traced"])
                print(f"wrote {tbpath} ({sum(counts.values())} "
                      f"grandfathered finding(s) across {len(counts)} "
                      f"fingerprint(s))")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        return 0

    clean = all(r.clean for r in reports.values())
    if args.format == "json":
        if args.tier == "all":
            payload = {"version": 1, "clean": clean,
                       "tiers": {k: r.to_json()
                                 for k, r in reports.items()}}
        else:
            payload = reports[args.tier].to_json()
            payload["tier"] = args.tier
        print(json.dumps(payload, indent=2))
    elif args.format == "github":
        for rep in reports.values():
            _emit_github(rep)
        labels = " + ".join(sorted(reports))
        n = sum(len(r.findings) for r in reports.values())
        print(f"lint[{labels}]: " +
              ("clean" if clean else f"{n} finding(s)"))
    else:
        if "ast" in reports:
            _emit_human("reprolint", reports["ast"], "modules")
        if "traced" in reports:
            _emit_human("tracelint", reports["traced"], "targets")
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
