"""Query-aware index optimization — sibling reordering (paper Algorithm
3). Port of ``repro/core/reorder.py`` (host Python over the tree's
numpy arrays, so both packages reorder identically from identical
counts).

Child lists of every internal node are re-sorted by access frequency
(descending) gathered from the QBS-instrumented workload; groups of
siblings with EQUAL frequency are brute-force permuted and the ordering
with the minimum measured workload cost wins. Inheritance is never
altered — only sibling order (paper §6.2).
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.index import ClusterTree


def reorder_siblings(tree: ClusterTree,
                     workload_cost: Optional[Callable[[], float]] = None,
                     max_tie_group: int = 4) -> int:
    """In-place Algorithm 3. Returns the number of child lists changed.

    ``workload_cost`` re-executes the query workload and returns its cost
    (time or node scans); it is used only to break ties, as in the paper.
    When None, ties keep their current relative order."""
    counts = tree.access_count
    changed = 0
    for node in range(tree.n_nodes):
        kids = tree.children[node]
        if len(kids) <= 1:
            continue
        order = np.argsort(-counts[kids], kind="stable")
        new = [kids[i] for i in order]
        if workload_cost is not None:
            new = _break_ties(tree, node, new, counts, workload_cost,
                              max_tie_group)
        if new != kids:
            tree.children[node] = new
            changed += 1
    return changed


def _break_ties(tree, node, ordered: List[int], counts, workload_cost,
                max_tie_group: int) -> List[int]:
    """Brute-force permutations within equal-frequency runs (Alg. 3
    l.9-19)."""
    out = list(ordered)
    i = 0
    while i < len(out):
        j = i
        while j < len(out) and counts[out[j]] == counts[out[i]]:
            j += 1
        run = out[i:j]
        if 1 < len(run) <= max_tie_group:
            best, best_cost = run, None
            for perm in itertools.permutations(run):
                out[i:j] = list(perm)
                tree.children[node] = out
                cost = workload_cost()
                if best_cost is None or cost < best_cost:
                    best, best_cost = list(perm), cost
            out[i:j] = best
            tree.children[node] = out
        i = j
    return out


def reset_access_counts(tree: ClusterTree):
    tree.access_count[:] = 0
