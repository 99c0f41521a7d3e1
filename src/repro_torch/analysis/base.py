"""Shared types of the port's static checks: violations and the committed
suppressions file.

A violation is (rule, subject, message); ``subject`` is either a
registered entry's name (``contracts``) or a ``path:line`` location
(``lint``). Deliberate exemptions live in ``suppressions.json`` beside
this module, and every entry MUST carry a non-empty ``reason``: an
exemption is a documented decision, never a silent skip.
"""

from __future__ import annotations

import dataclasses
import json
import os

SUPPRESSIONS_PATH = os.path.join(os.path.dirname(__file__), "suppressions.json")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: its rule (``contracts.RULES`` / ``lint.RULES``), the
    entry or ``path:line`` it anchors to, and what is wrong."""

    rule: str
    subject: str
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A committed exemption: (rule, subject or subject prefix) and why."""

    rule: str
    subject: str  # an exact entry name, or a path prefix for lint subjects
    reason: str

    def matches(self, v: Violation) -> bool:
        return v.rule == self.rule and (
            v.subject == self.subject or v.subject.startswith(self.subject)
        )


def load_suppressions(path: str = SUPPRESSIONS_PATH) -> list[Suppression]:
    """The committed suppressions; ``ValueError`` for an entry without a
    reason."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        raw = json.load(f)
    out = []
    for i, entry in enumerate(raw):
        reason = entry.get("reason", "").strip()
        if not reason:
            raise ValueError(
                f"suppressions.json entry {i} ({entry.get('rule')!r}, "
                f"{entry.get('subject')!r}) has no reason -- every exemption "
                "must say why"
            )
        out.append(Suppression(rule=entry["rule"], subject=entry["subject"], reason=reason))
    return out


def split_suppressed(
    violations: list[Violation], suppressions: list[Suppression]
) -> tuple[list[Violation], list[tuple[Violation, Suppression]]]:
    """(live violations, [(suppressed violation, its suppression)])."""
    live: list[Violation] = []
    quiet: list[tuple[Violation, Suppression]] = []
    for v in violations:
        hit = next((s for s in suppressions if s.matches(v)), None)
        if hit is None:
            live.append(v)
        else:
            quiet.append((v, hit))
    return live, quiet
