"""Maximum-weighted-matching backends (host / oracle side).

Mirrors ``lara::Matching`` (``reference/src/matching.hpp``):

* :func:`greedy_matching` -- the default greedy algorithm with lookahead
  (``computeGreedyMatching``, ``matching.hpp:143-192``) including the exact
  recursive conflict resolution (``solveConflicts``, ``matching.hpp:99-141``).
  The queue is a sorted set of ``(-2*score, lineL, lineR)`` tuples
  (``matching.hpp:149-151``), so iteration order is: heaviest first, ties by
  smaller line indices.
* :func:`exact_matching` -- the ``-m 0`` escape hatch; the reference uses
  LEMON's ``MaxWeightedMatching`` (``matching.hpp:201-238``).  lara-tpu uses
  the native C++ blossom implementation when built, else networkx.  NOTE the
  reference quirk: in LEMON mode *every* line is pre-inserted as its own
  contact (``matching.hpp:210``), so ``contacts`` contains all lines (this
  makes all output weights 1000 in binary libscore mode); replicated here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interaction = Tuple[int, int, int]  # (-2*score, lineL, lineR)


def _has_conflict(a: Interaction, b: Interaction) -> bool:
    return a[1] == b[1] or a[1] == b[2] or a[2] == b[1] or a[2] == b[2]


def solve_conflicts(conflicts: List[Tuple[Interaction, Interaction]]):
    """Exact mirror of ``solveConflicts`` (``matching.hpp:99-141``).

    Returns ``(eliminate_set, eliminated_weight)``.  ``conflicts`` is an
    ordered list of interaction pairs; the recursion branches on the first
    conflict, preferring to eliminate the lighter edge (edgeS = the
    tuple-greater interaction), and explores the other branch only when the
    first is strictly heavier in total.
    """
    if not conflicts:
        return set(), 0
    first_a, first_b = conflicts[0]
    # std::min/std::max with cmp(a,b) = (*a >= *b):
    # edgeS = tuple-greater (lighter weight), edgeL = tuple-smaller (heavier).
    edge_s = max(first_a, first_b)
    edge_l = min(first_a, first_b)
    weight_s = -edge_s[0]
    weight_l = -edge_l[0]

    if len(conflicts) == 1:
        return {edge_s}, weight_s

    remaining_s = [c for c in conflicts if edge_s != c[0] and edge_s != c[1]]
    eliminate_s, sub_s = solve_conflicts(remaining_s)
    weight_s += sub_s

    if weight_s > weight_l:
        remaining_l = [c for c in conflicts if edge_l != c[0] and edge_l != c[1]]
        if remaining_s != remaining_l:
            eliminate_l, sub_l = solve_conflicts(remaining_l)
            weight_l += sub_l
            if weight_s > weight_l:
                eliminate_l = set(eliminate_l)
                eliminate_l.add(edge_l)
                return eliminate_l, weight_l
    eliminate_s = set(eliminate_s)
    eliminate_s.add(edge_s)
    return eliminate_s, weight_s


def greedy_matching(
    possible_partners: Sequence[Sequence[Tuple[int, int]]],
    current_alignment: Sequence[int],
    lookahead: int,
) -> Tuple[int, Dict[int, int]]:
    """Greedy lookahead matching; returns (score, contacts).

    ``possible_partners[idx]`` lists ``(score, partner_edge_id)`` for line
    ``current_alignment[idx]``; entries exist only for partner ids greater
    than the line id (``lagrange.hpp:385-391``), so each interaction enters
    the queue once.
    """
    queue = set()
    for idx in range(len(current_alignment)):
        for score, partner in possible_partners[idx]:
            queue.add((-2 * int(score), int(current_alignment[idx]), int(partner)))
    queue = sorted(queue)

    if lookahead > len(queue):
        lookahead = len(queue)
    elif lookahead == 0:
        lookahead = 5

    contacts: Dict[int, int] = {}
    total = 0
    pos = 0
    while pos < len(queue):
        selection: List[Interaction] = []
        while len(selection) < lookahead and pos < len(queue):
            entry = queue[pos]
            pos += 1
            if entry[1] not in contacts and entry[2] not in contacts:
                selection.append(entry)

        conflicts: List[Tuple[Interaction, Interaction]] = []
        for i in range(len(selection)):
            for j in range(i + 1, len(selection)):
                if _has_conflict(selection[i], selection[j]):
                    conflicts.append((selection[i], selection[j]))

        eliminate, _weight = solve_conflicts(conflicts)

        for entry in selection:
            if entry not in eliminate:
                contacts[entry[1]] = entry[2]
                contacts[entry[2]] = entry[1]
                total += -entry[0]
    return total, contacts


def exact_matching(
    possible_partners: Sequence[Sequence[Tuple[int, int]]],
    current_alignment: Sequence[int],
) -> Tuple[int, Dict[int, int]]:
    """Exact maximum weighted matching (LEMON-equivalent, ``-m 0``).

    Edge weights are doubled like the reference (``matching.hpp:222``), and
    every line starts as its own contact (``matching.hpp:210`` quirk).
    """
    contacts: Dict[int, int] = {line: line for line in current_alignment}
    edges = []
    for idx, line in enumerate(current_alignment):
        for score, partner in possible_partners[idx]:
            edges.append((int(line), int(partner), 2 * int(score)))
    if not edges:
        return 0, contacts
    native_ok = False
    try:
        from lara_tpu_torch.native import NativeBuildError, blossom

        try:
            total, pairs = blossom.max_weight_matching(edges)
            native_ok = True
        except NativeBuildError:
            pass
    except ImportError:
        pass
    if not native_ok:
        import networkx as nx

        graph = nx.Graph()
        graph.add_nodes_from(contacts)
        for u, v, w in edges:
            # parallel edges: keep the heaviest (LEMON allows parallels; MWM
            # never benefits from the lighter one)
            if graph.has_edge(u, v):
                if graph[u][v]["weight"] >= w:
                    continue
            graph.add_edge(u, v, weight=w)
        mate = nx.max_weight_matching(graph, maxcardinality=False)
        pairs = list(mate)
        total = sum(graph[u][v]["weight"] for u, v in pairs)
    for u, v in pairs:
        contacts[u] = v
        contacts[v] = u
    return int(total), contacts
