"""Balanced K-way cut search over a ``ModelCosts`` table (counterpart of
``repro/plan/search.py``).

The partition problem is the classic *chains-on-chains* bottleneck
minimization: place K-1 cuts in an ordered sequence of units so the most
expensive stage is as cheap as possible.  Stage cost is NOT a pure interval
sum here — stage 0 carries the embedding/encoder overhead and the last
stage carries the final-norm/unembedding overhead — but only the first and
last stages are special, so a suffix DP over (start unit, stages remaining)
still solves it exactly in O(n^2 K) O(1)-cost evaluations.

Determinism/tie-breaking: among all optimal-bottleneck solutions the
searcher picks cuts greedily left-to-right, each as close as possible to
the *uniform* (divmod-balanced) cut — so on a perfectly uniform model
(e.g. an equal-width MLP, where every split of the right sizes ties) it
reproduces ``partition.make_plan``'s hand bounds exactly, as the
reference's does (``tests/test_torch_plan.py`` holds the two searchers
equal).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.plan.costs import ModelCosts, StageCost, predicted_imbalance

Bounds = Tuple[Tuple[int, int], ...]

# float-sum noise guard when re-checking DP-optimal feasibility
_EPS = 1e-9


def uniform_bounds(n_units: int, n_stages: int) -> Bounds:
    """The divmod-balanced contiguous split (``partition.make_plan``'s
    scheme: earlier stages take the remainder)."""
    base, rem = divmod(n_units, n_stages)
    bounds, start = [], 0
    for k in range(n_stages):
        size = base + (1 if k < rem else 0)
        bounds.append((start, start + size))
        start += size
    return tuple(bounds)


def stage_objective(costs: ModelCosts, objective: str = "bytes"
                    ) -> Callable[[int, int, int, int], float]:
    """(lo, hi, k, n_stages) -> scalar stage cost under the objective.

    * ``bytes`` (default) — resident params + optimizer slots + activation
      stream + boundary spill.  This is what device memory actually caps,
      and what the LPT packing in ``dist/placement`` bins by.
    * ``flops`` — per-stage training FLOPs (use when stages share devices
      and compute, not memory, is the bottleneck).
    """
    if objective == "bytes":
        return lambda lo, hi, k, n: float(
            costs.stage_cost(lo, hi, k, n).bytes_total)
    if objective == "flops":
        return lambda lo, hi, k, n: costs.stage_cost(lo, hi, k, n).flops
    raise ValueError(f"unknown objective {objective!r}; "
                     "expected 'bytes' or 'flops'")


def solve(costs: ModelCosts, n_stages: int, *, objective: str = "bytes"
          ) -> Bounds:
    """Optimal-bottleneck bounds, tie-broken toward the uniform split."""
    n = costs.n_units
    if not 1 <= n_stages <= n:
        raise ValueError(f"{n_stages} stages over {n} units")
    if n_stages == 1:
        return ((0, n),)
    cost = stage_objective(costs, objective)

    # suffix[j][m]: minimal bottleneck of splitting units [j, n) into the
    # FINAL m stages (so the last of them carries the tail overhead; none
    # carries the head).  Stage index passed to `cost` only distinguishes
    # first/interior/last, so k=1 stands in for "interior".
    K = n_stages
    suffix = [[float("inf")] * (K + 1) for _ in range(n + 1)]
    for j in range(n):
        suffix[j][1] = cost(j, n, K - 1, K)
    for m in range(2, K):
        for j in range(n - m + 1):
            best = float("inf")
            for hi in range(j + 1, n - m + 2):
                c = max(cost(j, hi, 1, K), suffix[hi][m - 1])
                if c < best:
                    best = c
            suffix[j][m] = best

    # bottleneck with the head-overhead first stage
    bstar = min(max(cost(0, hi, 0, K), suffix[hi][K - 1])
                for hi in range(1, n - K + 2))

    # greedy reconstruction: each cut as close to the uniform target as
    # possible while staying feasible at the optimal bottleneck
    targets = [hi for _, hi in uniform_bounds(n, K)[:-1]]
    limit = bstar * (1 + _EPS) + _EPS
    bounds: List[Tuple[int, int]] = []
    lo = 0
    for k in range(K - 1):
        remaining = K - 1 - k
        feasible = []
        for hi in range(lo + 1, n - remaining + 1):
            if cost(lo, hi, k, K) <= limit and suffix[hi][remaining] <= limit:
                feasible.append(hi)
        if not feasible:   # numerically unreachable; keep a hard fallback
            feasible = [lo + 1]
        hi = min(feasible, key=lambda h: (abs(h - targets[k]), h))
        bounds.append((lo, hi))
        lo = hi
    bounds.append((lo, n))
    return tuple(bounds)


def frontier(costs: ModelCosts, n_stages: int, chosen: Bounds, *,
             objective: str = "bytes", limit: int = 16) -> List[Dict]:
    """The rejected alternatives the searcher weighed, for PLAN_7.json.

    Full enumeration when the cut lattice is small (C(n-1, K-1) <= 512);
    otherwise every single-cut perturbation of the chosen bounds.  Entries
    are sorted by bottleneck cost and capped at ``limit`` (the cap is
    recorded by the caller — no silent truncation)."""
    n = costs.n_units
    cost = stage_objective(costs, objective)
    chosen_cuts = tuple(hi for _, hi in chosen[:-1])

    def bounds_of(cuts: Sequence[int]) -> Bounds:
        edges = [0, *cuts, n]
        return tuple((edges[i], edges[i + 1]) for i in range(len(edges) - 1))

    def bottleneck(b: Bounds) -> float:
        return max(cost(lo, hi, k, n_stages)
                   for k, (lo, hi) in enumerate(b))

    from itertools import combinations
    from math import comb
    cand: List[Tuple[int, ...]] = []
    if n_stages > 1 and comb(n - 1, n_stages - 1) <= 512:
        cand = [c for c in combinations(range(1, n), n_stages - 1)
                if c != chosen_cuts]
    else:
        seen = {chosen_cuts}
        for i in range(len(chosen_cuts)):
            for delta in (-1, 1):
                c = list(chosen_cuts)
                c[i] += delta
                lo_ok = c[i] > (c[i - 1] if i else 0)
                hi_ok = c[i] < (c[i + 1] if i + 1 < len(c) else n)
                t = tuple(c)
                if lo_ok and hi_ok and t not in seen:
                    seen.add(t)
                    cand.append(t)
    base = bottleneck(chosen)
    rows = []
    for cuts in cand:
        b = bounds_of(cuts)
        bn = bottleneck(b)
        rows.append({"bounds": [list(x) for x in b],
                     "bottleneck": float(bn),
                     "vs_chosen": float(bn / base) if base else 1.0})
    rows.sort(key=lambda r: (r["bottleneck"], r["bounds"]))
    return rows[:limit]


def search_report(costs: ModelCosts, n_stages: int, *,
                  objective: str = "bytes",
                  frontier_limit: int = 16) -> Dict:
    """One arch's full search result: chosen bounds + per-stage predicted
    costs, the uniform split's for comparison, imbalance ratios, and the
    rejected frontier."""
    chosen = solve(costs, n_stages, objective=objective)
    uni = uniform_bounds(costs.n_units, n_stages)
    chosen_sc = costs.stage_costs(chosen)
    uni_sc = costs.stage_costs(uni)

    def side(bounds: Bounds, sc: List[StageCost]) -> Dict:
        return {
            "bounds": [list(b) for b in bounds],
            "cuts": [hi for _, hi in bounds[:-1]],
            "stages": [c.row() for c in sc],
            "bottleneck_bytes": int(max(c.bytes_total for c in sc)),
            "bottleneck_flops": float(max(c.flops for c in sc)),
            "imbalance": round(predicted_imbalance(sc), 6),
        }

    rej = frontier(costs, n_stages, chosen, objective=objective,
                   limit=frontier_limit)
    return {
        "objective": objective,
        "n_units": costs.n_units,
        "n_stages": n_stages,
        "optimizer": costs.optimizer,
        "auto": side(chosen, chosen_sc),
        "uniform": side(uni, uni_sc),
        "auto_le_uniform": max(c.bytes_total for c in chosen_sc)
        <= max(c.bytes_total for c in uni_sc),
        "rejected_frontier": rej,
        "frontier_truncated_to": frontier_limit,
    }


def brute_force_bounds(costs: ModelCosts, n_stages: int, *,
                       objective: str = "bytes") -> Tuple[float, Bounds]:
    """Exhaustive reference solver (tests only): (bottleneck, some argmin)."""
    from itertools import combinations
    n = costs.n_units
    cost = stage_objective(costs, objective)
    best, best_b = float("inf"), None
    for cuts in combinations(range(1, n), n_stages - 1):
        edges = [0, *cuts, n]
        b = tuple((edges[i], edges[i + 1]) for i in range(len(edges) - 1))
        bn = max(cost(lo, hi, k, n_stages) for k, (lo, hi) in enumerate(b))
        if bn < best:
            best, best_b = bn, b
    return best, best_b


def searched_bounds_for_sequence(unit_costs: Sequence[float],
                                 n_stages: int) -> Bounds:
    """Bottleneck-optimal bounds over a bare per-unit scalar cost sequence
    (no head/tail overheads) — the ``balanced_bounds(..., costs=[...])``
    entry point."""
    seq = [float(c) for c in unit_costs]
    mc = ModelCosts(kind="mlp", n_units=len(seq), optimizer="sgd",
                    unit_param_bytes=tuple(int(c) for c in seq),
                    unit_param_elems=(0,) * len(seq),
                    unit_act_bytes=(0,) * len(seq),
                    unit_flops=tuple(seq),
                    unit_boundary_bytes=(0,) * len(seq))
    return solve(mc, n_stages, objective="flops")
