"""Offline tiling-factor search (§4.2, Fig. 7).

The paper uses MCTS for tiling factors + GA for compute ordering on the
simulated device, and grid search on the DaVinci NPU. We implement all of
them over the (H_h, N_Q, N_KV) space with the event simulator as the
evaluator, and record the best-so-far trajectory for the Fig. 7
convergence reproduction.
"""

from __future__ import annotations

import dataclasses
import math
import random

from repro_torch.sim.engine import SimResult, simulate
from repro_torch.sim.hw import HWConfig
from repro_torch.sim.schedules import Tiling, build_schedule, tiling_space
from repro_torch.sim.workload import AttentionWorkload


@dataclasses.dataclass
class SearchResult:
    method: str
    tiling: Tiling
    result: SimResult
    evals: int
    history: list[tuple[int, float]]  # (eval #, best cycles so far)


def _evaluate(method, w, t, hw, objective="cycles") -> float | None:
    tasks = build_schedule(method, w, t, hw)
    if tasks is None:
        return None
    r = simulate(tasks, hw)
    return r.cycles if objective == "cycles" else r.energy_pj


def _finish(method, w, hw, best_t, evals, history) -> SearchResult:
    tasks = build_schedule(method, w, best_t, hw)
    return SearchResult(method, best_t, simulate(tasks, hw), evals, history)


def grid_search(method, w, hw, objective="cycles") -> SearchResult:
    """Exhaustive sweep — the DaVinci-NPU strategy."""
    best_t, best_c, history = None, math.inf, []
    evals = 0
    for t in tiling_space(w, hw):
        c = _evaluate(method, w, t, hw, objective)
        evals += 1
        if c is not None and c < best_c:
            best_t, best_c = t, c
        history.append((evals, best_c))
    assert best_t is not None, f"{method}: no feasible tiling for {w.name}"
    return _finish(method, w, hw, best_t, evals, history)


def random_search(method, w, hw, iters=200, seed=0, objective="cycles"):
    rng = random.Random(seed)
    space = tiling_space(w, hw)
    best_t, best_c, history = None, math.inf, []
    for i in range(iters):
        t = rng.choice(space)
        c = _evaluate(method, w, t, hw, objective)
        if c is not None and c < best_c:
            best_t, best_c = t, c
        history.append((i + 1, best_c))
    assert best_t is not None
    return _finish(method, w, hw, best_t, iters, history)


def _factor_levels(space) -> list[list]:
    """Per-tier value sets of the tiling space
    (H_h, N_Q, N_KV, kv_bpe, chunk, spec, cache_frac, shard).

    kv_bpe/chunk/spec/cache_frac/shard sort with ``None`` (native
    precision / monolithic admission / plain decode / sharing off /
    single chip) first so the level ordering is deterministic for
    spaces that don't search them; the fifth gene widens the MCTS tree
    and the GA genome only for chunked-prefill workloads (DESIGN.md
    §6), where it carries the prompt-chunk size, the sixth only for
    speculative-decode workloads (DESIGN.md §9), where it carries the
    verify depth, the seventh only for shared-prefix workloads
    (DESIGN.md §10), where it carries the pool fraction reserved for
    the prefix cache, and the eighth only for sharded-serving
    workloads (DESIGN.md §11), where it carries the mesh shard degree.
    """
    hhs = sorted({t.hh for t in space})
    nqs = sorted({t.nq for t in space})
    nkvs = sorted({t.nkv for t in space})
    none_first = lambda v: (-1 if v is None else v)  # noqa: E731
    bpes = sorted({t.kv_bpe for t in space}, key=none_first)
    chunks = sorted({t.chunk for t in space}, key=none_first)
    specs = sorted({t.spec for t in space}, key=none_first)
    fracs = sorted({t.cache_frac for t in space}, key=none_first)
    shards = sorted({t.shard for t in space}, key=none_first)
    return [hhs, nqs, nkvs, bpes, chunks, specs, fracs, shards]


def mcts_search(method, w, hw, iters=400, seed=0, c_ucb=1.2,
                objective="cycles") -> SearchResult:
    """Monte-Carlo tree search over the tiered tiling decisions.

    Tree levels mirror the paper's per-loop factor assignment: level 1
    picks H_h, level 2 picks N_Q, level 3 picks N_KV, level 4 the KV
    element width (precision as a tiling factor, DESIGN.md §5), level 5
    the prefill chunk size (chunked-admission workloads, DESIGN.md §6),
    level 6 the speculation depth (speculative-decode workloads,
    DESIGN.md §9), level 7 the cache-reserve fraction (shared-prefix
    workloads, DESIGN.md §10), level 8 the mesh shard degree
    (sharded-serving workloads, DESIGN.md §11); rollouts complete the
    remaining levels uniformly; rewards back-propagate 1/cycles.
    """
    rng = random.Random(seed)
    space = tiling_space(w, hw)
    levels = _factor_levels(space)

    stats: dict[tuple, list[float]] = {}  # node path -> [visits, total reward]

    def ucb(path, parent_visits):
        s = stats.get(path)
        if s is None or s[0] == 0:
            return math.inf
        return s[1] / s[0] + c_ucb * math.sqrt(
            math.log(parent_visits + 1) / s[0]
        )

    best_t, best_c, history = None, math.inf, []
    scale = None
    for it in range(iters):
        # selection/expansion down the 3 levels
        path: tuple = ()
        for lvl in levels:
            pv = stats.get(path, [0, 0.0])[0]
            choice = max(lvl, key=lambda x: ucb(path + (x,), pv))
            path = path + (choice,)
        t = Tiling(*path)
        c = _evaluate(method, w, t, hw, objective)
        if c is None:
            reward = 0.0
        else:
            if scale is None:
                scale = c
            reward = scale / c  # ~1 at the first feasible point, grows as
            if c < best_c:      # better tilings are found
                best_t, best_c = t, c
        for k in range(len(path) + 1):
            node = path[:k]
            s = stats.setdefault(node, [0, 0.0])
            s[0] += 1
            s[1] += reward
        history.append((it + 1, best_c))
    assert best_t is not None, f"MCTS found no feasible tiling ({method})"
    return _finish(method, w, hw, best_t, iters, history)


def ga_search(method, w, hw, iters=400, seed=0, pop=24,
              objective="cycles") -> SearchResult:
    """Genetic search: genome = (hh, nq, nkv, kv_bpe, chunk, spec,
    cache_frac, shard); tournament + crossover +
    mutation. (The paper's GA refines compute orderings of the analysis
    tree; our schedules fix the Alg. 1 order, so GA here explores the
    same genome space as MCTS — convergence comparison stays meaningful.)
    """
    rng = random.Random(seed)
    space = tiling_space(w, hw)
    levels = _factor_levels(space)

    def rand_g():
        return tuple(rng.choice(lvl) for lvl in levels)

    def fitness(g):
        c = _evaluate(method, w, Tiling(*g), hw, objective)
        return math.inf if c is None else c

    population = [rand_g() for _ in range(pop)]
    scores = [fitness(g) for g in population]
    evals = pop
    best_c = min(scores)
    best_g = population[scores.index(best_c)] if best_c < math.inf else None
    history = [(evals, best_c)]

    while evals < iters:
        def pick():
            i, j = rng.randrange(pop), rng.randrange(pop)
            return population[i] if scores[i] <= scores[j] else population[j]

        a, bg = pick(), pick()
        n_genes = len(levels)
        child = tuple(a[k] if rng.random() < 0.5 else bg[k]
                      for k in range(n_genes))
        if rng.random() < 0.3:  # mutate one gene
            k = rng.randrange(n_genes)
            child = tuple(
                rng.choice(levels[k]) if kk == k else child[kk]
                for kk in range(n_genes)
            )
        f = fitness(child)
        evals += 1
        worst = max(range(pop), key=lambda i: scores[i])
        if f <= scores[worst]:
            population[worst], scores[worst] = child, f
        if f < best_c:
            best_c, best_g = f, child
        history.append((evals, best_c))
    assert best_g is not None
    return _finish(method, w, hw, Tiling(*best_g), evals, history)


_STRATEGIES = {
    "grid": grid_search,
    "random": random_search,
    "mcts": mcts_search,
    "ga": ga_search,
}


def fusemax_tiling(w: AttentionWorkload) -> Tiling:
    """FuseMax uses manually selected tile sizes (paper §5.5 note: it is
    excluded from the search-convergence study)."""
    return Tiling(hh=1, nq=min(64, w.seq), nkv=min(256, w.seq))


def search_tiling(method: str, w: AttentionWorkload, hw: HWConfig,
                  strategy: str = "grid", **kw) -> SearchResult:
    if method == "fusemax":
        t = fusemax_tiling(w)
        tasks = build_schedule(method, w, t, hw)
        assert tasks is not None
        r = simulate(tasks, hw)
        return SearchResult(method, t, r, 1, [(1, r.cycles)])
    return _STRATEGIES[strategy](method, w, hw, **kw)
