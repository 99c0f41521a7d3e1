"""The port's static checks: contract checker, AST lint and sanitizer.

``python -m repro_torch.analysis`` runs every registered hot entry point
(``registry``) at its pinned shapes under fake tensors and checks the
contract rules (``contracts``), runs the port's AST lint (``lint``),
subtracts the committed suppressions (``suppressions.json``, each with a
written reason) and reports. The exit code is 0 if and only if no
violation is left unsuppressed. ``sanitizers`` counts the host syncs of a
running engine on the card.

The reference's Pallas BlockSpec rules have no counterpart (the CUDA
wrappers check their own shapes), and its recompile budgets wait for a
captured engine step.
"""

from __future__ import annotations

from repro_torch.analysis.base import (
    Suppression,
    Violation,
    load_suppressions,
    split_suppressed,
)


def run_analysis(include_contracts: bool = True, include_lint: bool = True) -> dict:
    """Run the static checks; returns the report dict.

    ``report["violations"]`` is the LIVE (unsuppressed) list, empty on a
    clean tree. Suppressed findings are reported too, each with its
    reason: the report is an inventory, not a filter.
    """
    from repro_torch.analysis import contracts, lint, registry

    violations: list[Violation] = []
    entry_rows: list[dict] = []
    rule_ids: list[str] = []
    if include_contracts:
        found, entry_rows = contracts.check_registry(registry.build_registry())
        violations.extend(found)
        rule_ids.extend(sorted(contracts.RULES))
    if include_lint:
        violations.extend(lint.check_tree())
        rule_ids.extend(sorted(lint.RULES))
    live, quiet = split_suppressed(violations, load_suppressions())
    return {
        "generated_by": "python -m repro_torch.analysis",
        "rules": rule_ids,
        "entries": entry_rows,
        "violations": [v.as_dict() for v in live],
        "suppressed": [{**v.as_dict(), "reason": s.reason} for v, s in quiet],
        "summary": {
            "rules": len(rule_ids),
            "entries_run": len(entry_rows),
            "violations": len(live),
            "suppressed": len(quiet),
        },
    }


__all__ = [
    "Suppression",
    "Violation",
    "load_suppressions",
    "run_analysis",
    "split_suppressed",
]
