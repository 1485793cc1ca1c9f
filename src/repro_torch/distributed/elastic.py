"""Elastic scaling at combining-phase boundaries: a copy of the JAX
package's ``distributed/elastic.py`` (plain Python).

DFC makes elastic resizes natural: the announcement array is sized N_max and
the *active worker set* is just manifest metadata -- growing or shrinking the
job is a combining phase that (1) commits the current state, (2) rewrites
the active set, (3) re-shards the data-cursor space.  Workers joining later
announce into their pre-allocated slot (the paper's late-arrival path);
departed workers simply stop announcing and the combiner's quorum logic
(straggler deadline) proceeds without them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class ElasticPlan:
    old_workers: List[int]
    new_workers: List[int]
    cursor_map: Dict[int, int]  # worker -> starting cursor after resize


def plan_resize(
    old_workers: List[int], new_workers: List[int], committed_cursor: int
) -> ElasticPlan:
    """Deterministic cursor re-sharding: the global batch stream is a single
    logical sequence; after resize each worker w (rank r of the new set)
    consumes cursors committed_cursor + r, + r + N, ...  — no sample is lost
    or duplicated across the resize (exactly-once extends across elasticity).
    """
    cursor_map = {
        w: committed_cursor + rank for rank, w in enumerate(sorted(new_workers))
    }
    return ElasticPlan(sorted(old_workers), sorted(new_workers), cursor_map)
