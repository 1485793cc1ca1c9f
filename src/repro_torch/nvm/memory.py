"""Per-tag pwb/pfence counters of the simulated persistence domain.

A copy of ``PersistStats`` from the JAX package's ``nvm/memory.py`` (its
counting, totals and ``as_dict``): the port keeps its own so that it imports nothing
of that package.  The cache-line NVM simulator stays with the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

#: Tag bucket for persistence ops issued without an attribution tag, so the
#: tag dicts always partition the totals (nothing is silently untagged).
DEFAULT_TAG = "untagged"


@dataclasses.dataclass
class PersistStats:
    """pwb/pfence counters, attributed by tag; untagged ops land in the
    :data:`DEFAULT_TAG` bucket."""

    pwb: Dict[str, int] = dataclasses.field(default_factory=dict)
    pfence: Dict[str, int] = dataclasses.field(default_factory=dict)

    def count_pwb(self, tag: Optional[str] = None) -> None:
        tag = tag or DEFAULT_TAG
        self.pwb[tag] = self.pwb.get(tag, 0) + 1

    def count_pfence(self, tag: Optional[str] = None) -> None:
        tag = tag or DEFAULT_TAG
        self.pfence[tag] = self.pfence.get(tag, 0) + 1

    def total_pwb(self) -> int:
        return sum(self.pwb.values())

    def total_pfence(self) -> int:
        return sum(self.pfence.values())

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        """JSON-ready view (for result rows and metrics snapshots)."""
        return {"pwb": dict(self.pwb), "pfence": dict(self.pfence)}
