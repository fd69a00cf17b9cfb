"""Tree edit distance for kinematic-structure evaluation (host-side, pure
Python; the port's own copy of reart_tpu/graph/ted.py).

Parity target: utils/ted_utils.py of the reference, which serializes trees
under every BFS child-permutation and takes the minimum APTED ordered tree
edit distance with FREE renames (CustomConfig.rename = 0) — i.e. the labels
only matter through the child ordering of the serialization, so the metric is
a min-over-orderings structural distance. We reproduce the protocol with our
own Zhang-Shasha ordered-TED implementation (unit insert/delete, zero
rename), no external apted dependency.
"""

from __future__ import annotations

import itertools
from collections import deque


def find_root_node(edges) -> int:
    """Root of a child->parent edge list: the unique node with no parent.
    (ted_utils.py:14-21 — first node with no descendants in the c->p DAG.)"""
    children = {c for c, _ in edges}
    nodes = children | {p for _, p in edges}
    roots = sorted(nodes - children)
    assert roots, "no root: edge list has a cycle"
    return roots[0]


def _children_map(edges, root):
    """Undirected edge list + root -> {parent: [children]} (orientation away
    from root), mirroring to_DAG (kinematic_utils.py:36-51)."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    children, seen, queue = {}, {root}, deque([root])
    while queue:
        cur = queue.popleft()
        kids = sorted(adj.get(cur, set()) - seen)
        children[cur] = kids
        seen.update(kids)
        queue.extend(kids)
    n_nodes = len({a for e in edges for a in e}) if edges else 1
    assert len(seen) == n_nodes, "edge list is not a connected tree"
    return children


def _bfs_orders(children, root, limit=None):
    """All node orders reachable by BFS where each parent's children may be
    enqueued in any permutation (ted_utils.py:24-54). Yields tuples of nodes."""
    out = []

    def backtrack(queue, order):
        if limit is not None and len(out) >= limit:
            return
        if not queue:
            out.append(tuple(order))
            return
        queue = deque(queue)
        parent = queue.popleft()
        order = order + [parent]
        kids = children.get(parent, [])
        if not kids:
            backtrack(queue, order)
            return
        for perm in itertools.permutations(kids):
            backtrack(deque(list(queue) + list(perm)), order)

    backtrack(deque([root]), [])
    return out


def _ordered_tree(children, root, rank):
    """Nested ordered tree [child_trees...] with children sorted by rank
    (the serialization order of ted_utils.get_node_attr_list + sorted())."""
    kids = sorted(children.get(root, []), key=lambda c: rank[c])
    return [
        _ordered_tree(children, c, rank) for c in kids
    ]


def _postorder(tree):
    """Flatten an ordered tree into postorder node list; returns (lmld, n)
    where lmld[i] is the postorder index of i's leftmost leaf descendant."""
    lmld = []

    def walk(node):
        if not node:  # leaf
            lmld.append(len(lmld))
            return len(lmld) - 1
        first = None
        for child in node:
            f = walk(child)
            if first is None:
                first = lmld[f]
        lmld.append(first)
        return len(lmld) - 1

    walk(tree)
    return lmld


def _keyroots(lmld):
    seen = set()
    roots = []
    for i in range(len(lmld) - 1, -1, -1):
        if lmld[i] not in seen:
            roots.append(i)
            seen.add(lmld[i])
    return sorted(roots)


def zhang_shasha(tree1, tree2, ins: float = 1.0, dele: float = 1.0,
                 ren: float = 0.0) -> float:
    """Ordered tree edit distance (Zhang & Shasha 1989). Trees are nested
    lists of children; labels are ignored (rename cost is a constant `ren`,
    0 by default to match the reference's CustomConfig)."""
    l1, l2 = _postorder(tree1), _postorder(tree2)
    n1, n2 = len(l1), len(l2)
    kr1, kr2 = _keyroots(l1), _keyroots(l2)
    td = [[0.0] * n2 for _ in range(n1)]

    for i in kr1:
        for j in kr2:
            li, lj = l1[i], l2[j]
            m, n = i - li + 2, j - lj + 2
            fd = [[0.0] * n for _ in range(m)]
            for x in range(1, m):
                fd[x][0] = fd[x - 1][0] + dele
            for y in range(1, n):
                fd[0][y] = fd[0][y - 1] + ins
            for x in range(1, m):
                for y in range(1, n):
                    pi, pj = li + x - 1, lj + y - 1
                    if l1[pi] == li and l2[pj] == lj:
                        fd[x][y] = min(
                            fd[x - 1][y] + dele,
                            fd[x][y - 1] + ins,
                            fd[x - 1][y - 1] + ren,
                        )
                        td[pi][pj] = fd[x][y]
                    else:
                        fd[x][y] = min(
                            fd[x - 1][y] + dele,
                            fd[x][y - 1] + ins,
                            fd[l1[pi] - li][l2[pj] - lj] + td[pi][pj],
                        )
    return td[n1 - 1][n2 - 1]


# ---------------------------------------------------------------------------
# exact min-over-orderings via a free-sibling-order forest DP
# ---------------------------------------------------------------------------
#
# The reference enumerates EVERY BFS child-permutation of both trees and
# takes the min APTED over ordering pairs (ted_utils.py:24-54,127-156) —
# factorial blow-up per node, infeasible at fanout >= 8. The same quantity
# is computed here in one memoized DP: the Zhang-Shasha forest recursion,
# but with the "last tree" of each forest chosen FREELY at every step.
# Fixing a choice sequence is equivalent to fixing sibling orderings, so the
# DP minimum equals the min over all ordering pairs (verified by property
# test vs brute-force enumeration, tests/test_ted.py). States are canonical
# SHAPES (labels are free renames in the reference config), so identical
# subtrees collapse and bushy-but-regular part trees stay tiny.

def _shape(children, node):
    """Canonical unordered shape of the subtree at `node`: sorted tuple of
    child shapes (labels don't matter — renames are free)."""
    return tuple(sorted(_shape(children, c) for c in children.get(node, [])))


def _shape_size(shape) -> int:
    return 1 + sum(_shape_size(c) for c in shape)


def _forest_size(forest) -> int:
    return sum(_shape_size(t) for t in forest)


def _without(forest, t):
    """Forest minus ONE occurrence of tree shape t (forests are sorted)."""
    i = forest.index(t)
    return forest[:i] + forest[i + 1:]


def _spliced(forest, t):
    """Forest with tree t replaced by its children (root deleted)."""
    return tuple(sorted(_without(forest, t) + t))


def _shape_height(shape) -> int:
    return 1 + max((_shape_height(c) for c in shape), default=0)


def _forest_height(forest) -> int:
    return max((_shape_height(t) for t in forest), default=0)


import functools as _functools


def _forest_lower(f1, f2) -> float:
    """Admissible TED lower bound: every edit op changes the node count by
    exactly 1 and the forest height by at most 1."""
    return float(max(abs(_forest_size(f1) - _forest_size(f2)),
                     abs(_forest_height(f1) - _forest_height(f2))))


@_functools.lru_cache(maxsize=1 << 20)
def _free_forest_dist(f1, f2) -> float:
    """Min ordered forest TED over all sibling orderings of both forests
    (unit insert/delete, free rename).

    Branching follows the ordered ZS recursion with a free "last tree": ONE
    designated tree t1 on the left (delete its root / match it with any
    distinct right tree), plus root-inserts of every distinct right tree —
    designating t1 is WLOG because sibling orderings are free (property-
    tested against brute-force ordering enumeration, tests/test_ted.py).
    Identical shapes on both sides are matched first (cost 0) so the
    lower-bound early-exit fires on regular bushy trees.
    """
    if not f1:
        return float(_forest_size(f2))
    if not f2:
        return float(_forest_size(f1))
    if f1 == f2:
        return 0.0
    lower = _forest_lower(f1, f2)
    best = float("inf")
    # match identical sibling subtrees first: exact, and reaches the
    # lower bound fast on regular trees
    common = set(f1) & set(f2)
    t1 = max(common) if common else max(f1)
    if t1 in common:
        best = _free_forest_dist(_without(f1, t1), _without(f2, t1))
        if best <= lower:
            return best
    best = min(best, 1.0 + _free_forest_dist(_spliced(f1, t1), f2))
    if best <= lower:
        return best
    rest1 = _without(f1, t1)
    for t2 in dict.fromkeys(f2):
        best = min(best, _free_forest_dist(rest1, _without(f2, t2))
                   + _free_forest_dist(t1, t2))
        if best <= lower:
            return best
    for t2 in dict.fromkeys(f2):
        best = min(best, 1.0 + _free_forest_dist(f1, _spliced(f2, t2)))
        if best <= lower:
            return best
    return best


def ted_exact(pred_children, pred_root, gt_children, gt_root) -> float:
    """Exact min-over-orderings TED of two rooted unordered trees."""
    s1 = _shape(pred_children, pred_root)
    s2 = _shape(gt_children, gt_root)
    return _free_forest_dist((s1,), (s2,))


def compute_ted(pred_edges, pred_root, gt_edges, gt_root,
                traverse: bool = True, max_traversals: int | None = 500,
                verbose: bool = False) -> float:
    """Min ordered TED over BFS child-permutation orderings of both trees
    (ted_utils.py:127-156), computed EXACTLY by the free-order forest DP.
    With traverse=False, a single canonical (sorted-children) ordering is
    used per tree (cheap upper bound, as before). max_traversals only
    bounds the legacy enumeration path (compute_ted_enumerated), kept for
    cross-checking."""
    pred_children = _children_map([tuple(e) for e in pred_edges], pred_root)
    gt_children = _children_map([tuple(e) for e in gt_edges], gt_root)
    if traverse:
        d = ted_exact(pred_children, pred_root, gt_children, gt_root)
        if verbose:
            print(f"final tree edit distance {d}")
        return d
    return compute_ted_enumerated(pred_edges, pred_root, gt_edges, gt_root,
                                  traverse=False,
                                  max_traversals=max_traversals,
                                  verbose=verbose)


def compute_ted_enumerated(pred_edges, pred_root, gt_edges, gt_root,
                           traverse: bool = True,
                           max_traversals: int | None = 500,
                           verbose: bool = False) -> float:
    """The reference's literal protocol: enumerate BFS child-permutation
    orderings (optionally truncated) and min Zhang-Shasha over pairs. Kept
    as the oracle for the exact DP's property tests."""
    pred_children = _children_map([tuple(e) for e in pred_edges], pred_root)
    gt_children = _children_map([tuple(e) for e in gt_edges], gt_root)

    def orderings(children, root):
        if not traverse:
            order = []
            queue = deque([root])
            while queue:
                cur = queue.popleft()
                order.append(cur)
                queue.extend(children.get(cur, []))
            return [tuple(order)]
        return _bfs_orders(children, root, limit=max_traversals)

    pred_orders = orderings(pred_children, pred_root)
    gt_orders = orderings(gt_children, gt_root)
    if max_traversals is not None and traverse and (
            len(pred_orders) >= max_traversals or len(gt_orders) >= max_traversals):
        import warnings

        warnings.warn(
            f"compute_ted: BFS-ordering enumeration truncated at "
            f"{max_traversals}; reported TED is an upper bound", stacklevel=2)
    pred_trees = [
        _ordered_tree(pred_children, pred_root, {v: i for i, v in enumerate(o)})
        for o in pred_orders
    ]
    gt_trees = [
        _ordered_tree(gt_children, gt_root, {v: i for i, v in enumerate(o)})
        for o in gt_orders
    ]
    # dedup identical ordered shapes before the quadratic sweep
    pred_trees = list({repr(t): t for t in pred_trees}.values())
    gt_trees = list({repr(t): t for t in gt_trees}.values())

    # size difference is a lower bound on TED — stop once reached
    n_pred = len({a for e in pred_edges for a in e} or {pred_root})
    n_gt = len({a for e in gt_edges for a in e} or {gt_root})
    lower = float(abs(n_pred - n_gt))

    best = float("inf")
    for p in pred_trees:
        for g in gt_trees:
            best = min(best, zhang_shasha(p, g))
            if best <= lower:
                if verbose:
                    print(f"final tree edit distance {best}")
                return best
    if verbose:
        print(f"final tree edit distance {best}")
    return best
