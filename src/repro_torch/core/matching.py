"""Maximum-weight bipartite matching for the winner-selection algorithm
(Algorithm 1): pair models with next-trainer PUEs maximizing total
diffusion efficiency (Eq. 38).

Counterpart of the host half of ``repro.core.matching``: a pure-numpy
O(n³) Kuhn–Munkres (Jonker–Volgenant potentials).  The jitted Bertsekas
auction of the reference arrives with the device planner.
"""
from __future__ import annotations

import numpy as np

__all__ = ["max_weight_matching", "hungarian_min_cost"]

_INF = float("inf")


def hungarian_min_cost(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Solve the rectangular assignment problem, minimizing total cost.

    Returns ``(row_ind, col_ind)`` with the optimal assignment, rows sorted.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    transposed = False
    if n > m:
        cost = cost.T
        n, m = m, n
        transposed = True

    # Jonker-Volgenant with row/col potentials; 1-based col sentinel at 0.
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)   # p[j] = row matched to col j (1-based)
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, _INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = _INF
            j1 = -1
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            for j in range(1, m + 1):
                if used[j]:
                    continue
                c = cur[j - 1]
                if c < minv[j]:
                    minv[j] = c
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    rows, cols = [], []
    for j, r in enumerate(p[1:]):
        if r > 0:
            rows.append(r - 1)
            cols.append(j)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = np.argsort(rows)
    rows, cols = rows[order], cols[order]
    if transposed:
        rows, cols = cols, rows
        order = np.argsort(rows)
        rows, cols = rows[order], cols[order]
    return rows, cols


def max_weight_matching(weight: np.ndarray, forbid: np.ndarray | None = None,
                        ) -> list[tuple[int, int]]:
    """Maximum-total-weight matching of models (rows) to PUEs (cols).

    Edges with non-positive weight or ``forbid[m, i]`` are left out of the
    result (Eq. 36 zeroes infeasible edges; constraint 18b needs a strictly
    positive decrement).  Returns a list of (model, pue) pairs."""
    w = np.array(weight, dtype=np.float64, copy=True)
    if forbid is not None:
        w[forbid] = -_INF
    n, m = w.shape
    # Pad with dummy zero-weight columns: "leave the model unmatched".
    big = np.full((n, m + n), 0.0)
    big[:, :m] = np.where(np.isfinite(w), w, -1e18)
    rows, cols = hungarian_min_cost(-big)
    return [(int(r), int(c)) for r, c in zip(rows, cols)
            if c < m and w[r, c] > 0 and np.isfinite(w[r, c])]
