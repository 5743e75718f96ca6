"""Contract checker CLI: ``python -m repro_torch.analysis.check`` (twin of
``repro/analysis/check.py``).

Runs the kernel contract registry (every registered entry point on its
canonical fixture, proving its launch, layout, dtype and shared-memory
invariants) and the port's AST lint, prints a summary, optionally
writes a JSON report, and exits nonzero on any violation.

    python -m repro_torch.analysis.check --all                # on the card
    python -m repro_torch.analysis.check --all --device cpu   # plain versions
    python -m repro_torch.analysis.check --contracts bucket.gains
    python -m repro_torch.analysis.check --ast --json report.json
    python -m repro_torch.analysis.check --list

``--device cuda`` (the default) needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import sys


def _run_contracts(names, device):
    from repro_torch.analysis import contracts

    registry = contracts.contracts_by_name()
    if names:
        unknown = sorted(set(names) - set(registry))
        if unknown:
            raise SystemExit(
                f"unknown contract(s) {unknown}; registered: "
                f"{sorted(registry)}")
        picked = [registry[n] for n in names]
    else:
        picked = list(registry.values())
    reports = []
    for contract in picked:
        report = contracts.run_contract(contract, device)
        reports.append(report)
        status = "ok" if report.ok else "FAIL"
        print(f"[{status:>4}] {report.name:<24} "
              f"launches={report.stats['launches']} "
              f"steps={report.stats['steps']}")
        for violation in report.violations:
            print(f"       - {violation.rule}: {violation.message}")
    if not names:
        missing = sorted(set(contracts.FAMILIES)
                         - {r.family for r in reports})
        if missing:
            print(f"[FAIL] registry does not cover families: {missing}")
            reports.append(None)    # force failure below
    return reports


def _run_ast(roots, repo_root):
    from repro_torch.analysis import ast_rules

    violations = ast_rules.lint_paths(roots or ast_rules.DEFAULT_ROOTS,
                                      repo_root)
    status = "ok" if not violations else "FAIL"
    print(f"[{status:>4}] ast-lint                 "
          f"violations={len(violations)}")
    for v in violations:
        print(f"       - {v.rule}: {v.file}:{v.line}: {v.message}")
    return violations


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Kernel contract checker + the port's AST lint")
    parser.add_argument("--all", action="store_true",
                        help="run every contract and the AST lint "
                             "(the default when no selector is given)")
    parser.add_argument("--contracts", nargs="*", metavar="NAME",
                        default=None,
                        help="run the contract registry; with NAMEs, "
                             "only those contracts")
    parser.add_argument("--ast", action="store_true",
                        help="run the AST lint")
    parser.add_argument("--roots", nargs="*", default=None,
                        help="AST lint roots (default: src/repro_torch "
                             "and chip_smoke.py)")
    parser.add_argument("--repo-root", default=".",
                        help="repository root the lint roots are "
                             "relative to")
    parser.add_argument("--device", default="cuda",
                        help="where the fixtures run: cuda (the kernels) "
                             "or cpu (the plain versions)")
    parser.add_argument("--json", metavar="PATH", default=None,
                        help="write the full JSON report here")
    parser.add_argument("--list", action="store_true",
                        help="list registered contracts and exit")
    args = parser.parse_args(argv)

    if args.list:
        from repro_torch.analysis import contracts
        for c in contracts.build_registry():
            print(f"{c.name:<24} [{c.family}] {c.description}")
        return 0

    run_contracts = args.all or args.contracts is not None
    run_ast = args.all or args.ast
    if not run_contracts and not run_ast:
        run_contracts = run_ast = True      # bare invocation = --all

    if run_contracts:
        from repro_torch.core import resolve_device
        resolve_device(args.device)     # raises for a card that is absent
    print(f"device: {args.device}")

    reports, ast_violations = [], []
    if run_contracts:
        reports = _run_contracts(args.contracts, args.device)
    if run_ast:
        ast_violations = _run_ast(args.roots, args.repo_root)

    ok = (all(r is not None and r.ok for r in reports)
          and not ast_violations)
    if args.json:
        payload = {
            "device": args.device,
            "ok": ok,
            "contracts": [r.as_json() for r in reports if r is not None],
            "ast": {
                "violations": [v.as_json() for v in ast_violations],
            },
        }
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"report written to {args.json}")

    print("all checks passed" if ok else "CHECKS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
