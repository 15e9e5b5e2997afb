"""Access grouping (paper Sec 3.2, Fig. 8).

A *group* is a set of accesses that can be live during the same cycle on the
same buffer of a memory.  Banking only needs to satisfy each group in
isolation.  We implement the paper's greedy algorithm with the obvious
correctness completion: when an access clashes with members of several
existing groups those groups are merged (concurrency must be handled jointly),
and when it clashes with none it founds a new group.

Reads and writes are grouped separately only insofar as the paper's port
model allows: a group mixes reads and writes freely; the port constraint k is
enforced later by Def 2.9.
"""

from __future__ import annotations

from typing import List

from .controller import UnrolledProgram, is_concurrent
from .polytope import AccessGroup


def build_groups(up: UnrolledProgram, memory: str) -> List[AccessGroup]:
    idxs = [i for i, a in enumerate(up.accesses) if a.memory == memory]
    groups: List[List[int]] = []
    for ia in idxs:
        clashing = []
        for g_id, grp in enumerate(groups):
            if any(is_concurrent(up, ia, ib) for ib in grp):
                clashing.append(g_id)
        if not clashing:
            groups.append([ia])
        else:
            keep = clashing[0]
            groups[keep].append(ia)
            # transitive merge of any other clashing group
            for g_id in reversed(clashing[1:]):
                groups[keep].extend(groups[g_id])
                del groups[g_id]
    return [AccessGroup([up.accesses[i] for i in grp]) for grp in groups]


def group_sizes(groups: List[AccessGroup]) -> List[int]:
    return [len(g) for g in groups]
