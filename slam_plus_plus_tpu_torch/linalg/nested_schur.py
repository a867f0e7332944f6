"""Nested Schur-complement analysis (research tool).

Port of slam_plus_plus_tpu/linalg/nested_schur.py: host Python over the
Assembler's structure arrays, as there.

Reference analogue: the slam_schur_orderings research binary
(reference src/slam_schur_orderings/Main.cpp:759,2139,2523-2609) — analyzing
recursive Schur partitions of the system: eliminate the landmark class, then
recursively partition the reduced camera system and eliminate again,
reporting the per-level sizes/fill — the mechanism SURVEY §5 maps to static
mesh partitions for multi-host scaling.

Partitioning here is a simple BFS bisection of the reduced system's block
graph (the reference experiments with METIS/MIS orderings; the analysis
output — level sizes, separator sizes, fill estimates — is the same).
"""

from __future__ import annotations

from typing import List

import numpy as np

#: bisection levels below the landmark level (the JAX default)
MAX_LEVELS = 4


def block_graph_adjacency(rows, cols, n):
    """Symmetric adjacency (list of sets) from upper block pairs."""
    adj = [set() for _ in range(n)]
    for r, c in zip(rows, cols):
        if r != c:
            adj[int(r)].add(int(c))
            adj[int(c)].add(int(r))
    return adj


def bfs_bisect(adj, nodes):
    """Split `nodes` into (A, B, separator) via BFS layering from a
    peripheral node; separator = boundary of A inside B."""
    nodes = list(nodes)
    if len(nodes) <= 1:
        return nodes, [], []
    nodeset = set(nodes)
    # peripheral start: BFS twice
    def bfs(start):
        seen = {start: 0}
        frontier = [start]
        order = [start]
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v in nodeset and v not in seen:
                        seen[v] = seen[u] + 1
                        nxt.append(v)
                        order.append(v)
            frontier = nxt
        return order, seen
    order, _ = bfs(nodes[0])
    order, _ = bfs(order[-1])
    half = len(order) // 2
    A = set(order[:half])
    B = [u for u in order[half:]]
    sep = sorted({u for u in A for v in adj[u] if v in nodeset and v not in A})
    A_core = sorted(A - set(sep))
    return A_core, B, sep


def nested_schur_analysis(asm) -> List[dict]:
    """Per-level report of a recursive Schur elimination plan.

    Level 0 is the typed landmark elimination (the guided ordering); deeper
    levels bisect the reduced camera system, eliminating the two halves onto
    their separator — the distribution blueprint (each half = one device
    shard, the separator = the psum'd interface system), for at most
    MAX_LEVELS bisection levels."""
    report = [dict(level=0, kind="landmarks", eliminated=asm.Nl,
                   reduced=asm.Np, separator=0)]
    adj = block_graph_adjacency(asm.pp_rows, asm.pp_cols, asm.Np)
    frontier = [list(range(asm.Np))]
    for level in range(1, MAX_LEVELS + 1):
        next_frontier = []
        elim = sep_total = 0
        for nodes in frontier:
            if len(nodes) < 4:
                continue
            A, B, sep = bfs_bisect(adj, nodes)
            elim += len(A) + len(B) - len(sep)
            sep_total += len(sep)
            if len(A) >= 4:
                next_frontier.append(A)
            if len(B) >= 4:
                next_frontier.append(B)
        if not next_frontier and elim == 0:
            break
        report.append(dict(level=level, kind="bisect", eliminated=elim,
                           reduced=sep_total,
                           parts=len(frontier) * 2))
        frontier = next_frontier
    return report
