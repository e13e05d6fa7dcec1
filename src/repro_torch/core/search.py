"""LExI Stage 2: budgeted per-layer top-k allocation (paper Alg. 2).

``evolutionary_search`` is the paper-faithful optimizer: population EA with
tournament selection, uniform crossover, budget-preserving +/-1 mutation and
feasibility projection, minimizing the separable proxy
``phi(k) = sum_j D_j(k_j)`` s.t. ``sum_j k_j = B`` and per-layer bounds.

``dp_optimal`` is a beyond-paper addition: because the objective is separable,
the exact optimum is computable with an O(L * B * k_max) dynamic program.  We
use it (a) as an oracle in tests -- the EA must match it on small instances --
and (b) as a faster production allocator.  Both return identical-format plans.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sensitivity import SensitivityTable


# --------------------------------------------------------------------------- #
# Shared helpers
# --------------------------------------------------------------------------- #


def _as_cost(table: SensitivityTable) -> np.ndarray:
    """cost[j, k-1] = D_j(k); columns follow table.target_topks (1..k_base)."""
    ks = list(table.target_topks)
    assert ks == list(range(1, table.k_base + 1)), "expect contiguous 1..k_base"
    return np.asarray(table.values, np.float64)


def fitness(cost: np.ndarray, plan: np.ndarray) -> float:
    return float(cost[np.arange(len(plan)), plan - 1].sum())


def _project(plan: np.ndarray, budget: int, kmin: np.ndarray, kmax: np.ndarray,
             rng: np.random.Generator) -> np.ndarray:
    """Repair: clip to bounds, then +/-1 random moves until sum == budget."""
    p = np.clip(plan, kmin, kmax).astype(np.int64)
    guard = 0
    while p.sum() != budget:
        guard += 1
        if guard > 100_000:
            raise RuntimeError("projection failed; infeasible constraints?")
        if p.sum() < budget:
            cands = np.flatnonzero(p < kmax)
            p[rng.choice(cands)] += 1
        else:
            cands = np.flatnonzero(p > kmin)
            p[rng.choice(cands)] -= 1
    return p


def _feasible(budget: int, kmin: np.ndarray, kmax: np.ndarray) -> bool:
    return kmin.sum() <= budget <= kmax.sum()


# --------------------------------------------------------------------------- #
# Paper Alg. 2: evolutionary search
# --------------------------------------------------------------------------- #


@dataclass
class SearchResult:
    plan: Tuple[int, ...]
    fitness: float
    budget: int
    history: List[float]          # best fitness per generation
    evaluations: int


def evolutionary_search(
    table: SensitivityTable,
    budget: int,
    *,
    k_min: int = 1,
    k_max: Optional[int] = None,
    population: int = 64,
    generations: int = 300,
    mutation_rate: float = 0.3,
    tournament: int = 4,
    seed: int = 0,
) -> SearchResult:
    cost = _as_cost(table)
    L = cost.shape[0]
    k_max = k_max if k_max is not None else table.k_base
    kmin = np.full(L, k_min, np.int64)
    kmax = np.full(L, k_max, np.int64)
    if not _feasible(budget, kmin, kmax):
        raise ValueError(f"budget {budget} infeasible for bounds "
                         f"[{kmin.sum()}, {kmax.sum()}]")
    rng = np.random.default_rng(seed)

    # ---- init: random feasible allocations ---- #
    pop = [_project(rng.integers(k_min, k_max + 1, size=L), budget, kmin, kmax, rng)
           for _ in range(population)]
    fits = [fitness(cost, p) for p in pop]
    evals = population
    history: List[float] = []

    def tournament_pick() -> np.ndarray:
        idx = rng.integers(0, len(pop), size=tournament)
        return pop[idx[np.argmin([fits[i] for i in idx])]]

    for _g in range(generations):
        # selection (tournament), uniform crossover
        p1, p2 = tournament_pick(), tournament_pick()
        alpha = rng.integers(0, 2, size=L).astype(bool)       # Bernoulli(0.5)
        child = np.where(alpha, p1, p2)
        # budget-preserving mutation: paired +1/-1 moves
        n_moves = rng.binomial(L, mutation_rate)
        for _ in range(n_moves):
            up = np.flatnonzero(child < kmax)
            dn = np.flatnonzero(child > kmin)
            if len(up) == 0 or len(dn) == 0:
                break
            i, j = rng.choice(up), rng.choice(dn)
            if i != j:
                child[i] += 1
                child[j] -= 1
        child = _project(child, budget, kmin, kmax, rng)      # repair
        f = fitness(cost, child)
        evals += 1
        # steady-state update: replace current worst if child improves on it
        worst = int(np.argmax(fits))
        if f < fits[worst]:
            pop[worst] = child
            fits[worst] = f
        history.append(min(fits))

    best = int(np.argmin(fits))
    return SearchResult(plan=tuple(int(v) for v in pop[best]),
                        fitness=fits[best], budget=budget, history=history,
                        evaluations=evals)


# --------------------------------------------------------------------------- #
# Beyond-paper: exact DP allocator
# --------------------------------------------------------------------------- #


def dp_optimal(
    table: SensitivityTable,
    budget: int,
    *,
    k_min: int = 1,
    k_max: Optional[int] = None,
) -> SearchResult:
    """Exact minimum of the separable objective via dynamic programming."""
    cost = _as_cost(table)
    L = cost.shape[0]
    k_max = k_max if k_max is not None else table.k_base
    kmin = np.full(L, k_min, np.int64)
    kmax = np.full(L, k_max, np.int64)
    if not _feasible(budget, kmin, kmax):
        raise ValueError(f"budget {budget} infeasible for bounds "
                         f"[{kmin.sum()}, {kmax.sum()}]")

    INF = float("inf")
    # f[b] = best cost using layers 0..j with total allocation b
    f = np.full(budget + 1, INF)
    f[0] = 0.0
    choice = np.zeros((L, budget + 1), np.int64)
    for j in range(L):
        g = np.full(budget + 1, INF)
        for b in range(budget + 1):
            for k in range(k_min, k_max + 1):
                if b - k >= 0 and f[b - k] < INF:
                    c = f[b - k] + cost[j, k - 1]
                    if c < g[b]:
                        g[b] = c
                        choice[j, b] = k
        f = g
    if not np.isfinite(f[budget]):
        raise ValueError("no feasible allocation")
    # backtrack
    plan = np.zeros(L, np.int64)
    b = budget
    for j in range(L - 1, -1, -1):
        plan[j] = choice[j, b]
        b -= plan[j]
    return SearchResult(plan=tuple(int(v) for v in plan),
                        fitness=float(f[budget]), budget=budget,
                        history=[float(f[budget])], evaluations=0)
