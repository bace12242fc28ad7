"""Maximum-weight bipartite matching for the winner-selection algorithm
(Algorithm 1): pair models with next-trainer PUEs maximizing total
diffusion efficiency (Eq. 38).

Counterpart of ``repro.core.matching``, with two solvers:

* :func:`hungarian_min_cost` / :func:`max_weight_matching` — a pure-numpy
  O(n³) Kuhn–Munkres (Jonker–Volgenant potentials), the host planner's;
* :func:`auction_assign` — the Bertsekas forward–reverse auction with
  ε-scaling on tensors, the device planner's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["max_weight_matching", "hungarian_min_cost", "auction_assign",
           "auction_matching"]

_INF = float("inf")
_BIG = 1e30          # finite stand-in for ∞ in the auction's float32 math


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


# ------------------------------------------------------- Bertsekas auction


def auction_assign(weight: torch.Tensor, phases: int = 10,
                   theta: float = 5.0, max_iters: int = 5000,
                   stats: dict | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward–reverse Jacobi auction with ε-scaling on ``weight``'s device.

    Args:
      weight: (R, C) float32 edge weights.  Entries that are non-positive
        or non-finite are infeasible (Eq. 36 zeroes them; constraint 18b
        needs a strictly positive decrement).
      phases: ε-scaling phases; prices persist across phases, assignments
        reset.  ε starts at ``max(weight)/4``, divides by ``theta`` per
        phase and is floored at ``1e-6·max(weight)``.
      max_iters: cap on bidding iterations per phase.
      stats: if given, ``"auction_iterations"`` and
        ``"auction_host_reads"`` are added to.

    Returns ``(dst, converged)``: (R,) int64, the matched column per row or
    -1 for "stay put", and a 0-d bool that is False when a phase hit
    ``max_iters`` before clearing its queue.

    The reference's ``jax.lax`` loops become Python loops: the phase
    condition (and with it the choice of a forward or a reverse step) is
    read on the host once per bidding iteration.  Each row owns a private
    zero-weight dummy column ("stay put").  Forward rounds
    let unassigned rows bid prices up; once every row is assigned but an
    object is stranded (unowned at a positive price), one reverse step lets
    the highest-priced stranded object undercut to win back its best row.
    Ties break to the first index, as ``jnp.argmax`` does; float32 all the
    way, with ε's schedule in the form XLA compiles it to,
    ``wmax·0.25·θ^(−p)``.
    """
    dev = weight.device
    r, c = weight.shape
    ct = c + r
    w = torch.where(torch.isfinite(weight) & (weight > 0.0),
                    weight.to(torch.float32),
                    torch.tensor(-_BIG, dtype=torch.float32, device=dev))
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    wmax = torch.clamp(torch.where(w > 0.0, w, zero).max(), min=1e-12)
    eps_floor = wmax * 1e-6
    dummies = torch.where(torch.eye(r, dtype=torch.bool, device=dev),
                          zero, -big)
    big_w = torch.cat([w, dummies], dim=1)                   # (R, C + R)
    iota_r = torch.arange(r, device=dev)
    iota_c = torch.arange(ct, device=dev)

    def forward_round(eps, prices, owner, col_of_row):
        unassigned = col_of_row < 0
        values = big_w - prices[None, :]
        best_j = torch.argmax(values, dim=1)
        best_v = values.max(dim=1).values
        is_best = iota_c[None, :] == best_j[:, None]
        second_v = torch.where(is_best, -big, values).max(dim=1).values
        second_v = torch.where(second_v > -_BIG / 2, second_v, best_v)
        bid = prices[best_j] + (best_v - second_v) + eps
        bid = torch.where(unassigned, bid, -big)
        bid_mat = torch.where(is_best, bid[:, None], -big)  # (R, C + R)
        col_bid = bid_mat.max(dim=0).values
        col_winner = torch.argmax(bid_mat, dim=0)
        has_bid = col_bid > -_BIG / 2
        return (torch.where(has_bid, col_bid, prices),
                torch.where(has_bid, col_winner, owner))    # evicts

    def reverse_step(eps, prices, owner, col_of_row):
        stranded = (owner < 0) & (prices > 0.0)
        j = torch.argmax(torch.where(stranded, prices, -torch.inf))
        cc = torch.clamp(col_of_row, 0, ct - 1)
        pi = big_w[iota_r, cc] - prices[cc]                 # row profits
        margin = big_w[:, j] - pi                           # (R,)
        i_star = torch.argmax(margin)
        b1 = margin[i_star]
        b2 = torch.clamp(torch.where(iota_r == i_star, -big, margin).max(),
                         min=0.0)                           # λ floors rivals
        act = b1 >= eps
        new_price = torch.where(act, torch.clamp(b2 - eps, min=0.0), zero)
        prices = torch.where(iota_c == j, new_price, prices)
        old = col_of_row[i_star]
        owner = torch.where(act & (iota_c == old), -1, owner)
        owner = torch.where(act & (iota_c == j), i_star, owner)
        return prices, owner

    def flags(prices, owner, col_of_row):
        """(any row unassigned, any object stranded) as one host read."""
        return torch.stack([(col_of_row < 0).any(),
                            ((owner < 0) & (prices > 0.0)).any()]).tolist()

    prices = torch.zeros((ct,), dtype=torch.float32, device=dev)
    col_of_row = torch.full((r,), -1, dtype=torch.int64, device=dev)
    converged = True
    iters = reads = 0
    for p in range(phases):
        eps = torch.maximum(
            wmax * 0.25 * torch.pow(torch.tensor(
                theta, dtype=torch.float32, device=dev), float(-p)),
            eps_floor)
        owner = torch.full((ct,), -1, dtype=torch.int64, device=dev)
        col_of_row = torch.full((r,), -1, dtype=torch.int64, device=dev)
        it = 0
        while True:
            unassigned, stranded = flags(prices, owner, col_of_row)
            reads += 1
            if not ((unassigned or stranded) and it < max_iters):
                break
            step = forward_round if unassigned else reverse_step
            prices, owner = step(eps, prices, owner, col_of_row)
            owned = owner[None, :] == iota_r[:, None]       # (R, C + R)
            col_of_row = torch.where(owned.any(dim=1),
                                     torch.argmax(owned.to(torch.int32),
                                                  dim=1), -1)
            it += 1
        iters += it
        converged = converged and not (unassigned or stranded)
    if stats is not None:
        stats["auction_iterations"] = (stats.get("auction_iterations", 0)
                                       + iters)
        stats["auction_host_reads"] = (stats.get("auction_host_reads", 0)
                                       + reads)
    matched_real = (col_of_row >= 0) & (col_of_row < c)
    has_weight = w[iota_r, torch.clamp(col_of_row, 0, c - 1)] > 0.0
    return (torch.where(matched_real & has_weight, col_of_row, -1),
            torch.tensor(converged, device=dev))


def auction_matching(weight: np.ndarray, forbid: np.ndarray | None = None
                     ) -> list[tuple[int, int]]:
    """:func:`max_weight_matching`'s (model, pue) pair-list contract, solved
    by :func:`auction_assign`.  Warns if an auction phase hit its iteration
    cap (the matching may then be partial)."""
    import warnings
    w = np.array(weight, dtype=np.float32, copy=True)
    if forbid is not None:
        w[forbid] = -np.inf
    dst, converged = auction_assign(torch.from_numpy(w))
    if not bool(converged):
        warnings.warn("auction_assign hit its iteration cap before "
                      "converging; the matching may be partial",
                      RuntimeWarning, stacklevel=2)
    return [(int(m), int(j)) for m, j in enumerate(dst.cpu().numpy())
            if j >= 0]
