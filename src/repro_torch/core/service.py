"""Online influence service — twin of ``repro.core.service``: a
generation-tagged sketch pool resident on the device, and batched
``(k, seed-constraint, budget)`` queries.

The packed RRR incidence stays resident as a pool of two OPIM halves
(R1 for selection, R2 for validation), and B concurrent queries are
answered with one batched solve over R1 (``maxcover.greedy_maxcover_batch``):
the pool is read in place by every query, and only the per-query state
(covered words, k seed slots, E exclusion slots) fans out.

Pool lifecycle, as the reference:

  * samples come in slabs of ``slab`` RRR sets; slab ``s`` of half ``h``
    is keyed ``key.fold_in(h).fold_in(s).fold_in(salt[s])``, where
    ``salt[s]`` is the generation that (re)sampled it — growth appends
    slabs and keeps every existing column, a mutation resamples only
    the slabs it can affect;
  * ``refresh`` grows theta (default: double, capped at ``max_theta``);
  * ``refresh_mutated`` resamples only slabs whose samples contain a
    touched vertex (a sample that never reached the head of a changed
    in-edge list never read it);
  * every refresh bumps ``generation``; tickets admitted on an older
    generation drain on its pool, and a retired generation raises
    :class:`StaleGenerationError`.

A query is *certified* when the OPIM certificate (``opim.certify``)
reaches ``alpha - query.eps``, or when its spread budget is below
``sigma_lower``.  :meth:`InfluenceService.serve` refreshes and re-admits
uncertified queries until they certify, ``max_theta`` is reached or a
deadline passes (then the answers are marked ``degraded``).

Everything lives on the graph's device; the ids and floats of every
answer equal the reference's for the same key.
"""
from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import StageClock, bitset, maxcover, opim, span
from repro_torch.core.prng import Key
from repro_torch.core.rrr import SAMPLERS as _SAMPLERS
from repro_torch.core.rrr import (graph_tables, resolve_sampler,
                                  sample_incidence)
from repro_torch.graphs.csr import CSRGraph
from repro_torch.runtime.faults import (FaultPlan, InjectedFault,
                                        fire as _fire_fault)

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# a batch of queries solved in one launch.
CONTRACT = dict(
    family="service",
    dtypes=("bool", "int32", "int64", "uint8"),
    # G >= 2 queries' gains and keys spill from the 128 registers a
    # thread of 512 may hold (32-112 bytes a thread)
    variants=dict(batched=dict(launches={"greedy_pick_batch": 1},
                               local_memory=("greedy_pick_batch",))),
)

# The reference's model codes (``repro/core/cascade.py:99``): a pool
# snapshot stores the index into this tuple, so the codes must match.
_MODELS = ("IC", "LT", "WC")


class EmptyPoolError(RuntimeError):
    """Raised when answering against a pool that holds no samples."""


class StaleGenerationError(RuntimeError):
    """Raised when a ticket's generation has been retired."""


class Query(NamedTuple):
    """One influence query.

    k:        max seeds to select (>= 1).
    excluded: vertex ids forbidden as seeds (seed-constraint).
    budget:   target expected spread; selection stops at the first seed
              whose running sketch estimate reaches it (None: k seeds).
    eps:      admission slack — certified when the OPIM guarantee
              reaches ``alpha - eps``.
    """
    k: int
    excluded: Tuple[int, ...] = ()
    budget: Optional[float] = None
    eps: float = 0.3


class Ticket(NamedTuple):
    """The query plus the pool generation it will be answered against."""
    generation: int
    query: Query


class Answer(NamedTuple):
    seeds: np.ndarray       # int32 [query.k]; -1 pads past k_used
    k_used: int             # seeds actually selected (budget/exhaustion)
    coverage: int           # R1 coverage of the selected seeds
    spread: float           # sketch estimate: coverage * n / theta
    sigma_lower: float      # certified lower bound on sigma(S)   (R2)
    sigma_upper: float      # certified upper bound on sigma(OPT) (R1)
    guarantee: float        # sigma_lower / sigma_upper
    certified: bool         # admission rule satisfied at this theta
    generation: int         # pool generation that answered
    degraded: bool = False  # serve() gave up (deadline / max_theta)


class SketchPool(NamedTuple):
    """Generation-tagged resident sketch pool (two OPIM halves).

    ``r1``/``r2`` are packed incidences int32 [n, W] on the graph's
    device with ``theta = 32 * W`` samples each; ``salt`` is int32
    [num_slabs], the generation that sampled each slab.  ``typed_key``
    records whether the reference's key was a typed key (snapshots carry
    the flag; the key's words are the same either way).
    """
    g: CSRGraph
    r1: torch.Tensor
    r2: torch.Tensor
    theta: int
    generation: int
    salt: np.ndarray
    key: Key
    slab: int
    model: str
    sampler: str
    coin_chunk: int
    max_steps: int
    typed_key: bool = False

    @property
    def n(self) -> int:
        return self.g.num_vertices

    @property
    def words(self) -> int:
        return bitset.num_words(self.theta)


def _round_to_slabs(theta: int, slab: int) -> int:
    return int(math.ceil(theta / slab)) * slab if theta > 0 else 0


def _sample_slabs(g: CSRGraph, key: Key, slabs: Sequence[Tuple[int, int]],
                  *, slab: int, model: str, sampler: str, coin_chunk: int,
                  max_steps: int, plan: Optional[FaultPlan] = None):
    """[n, slab/32] incidence blocks of each (slab index, salt) of both
    halves -> (blocks1, blocks2).  Each fill is a ``sampler.slab_fill``
    fault site; a fill is a pure function of (key, slab, salt), so an
    aborted build can be retried."""
    n = g.num_vertices
    nbr, prob, wt, fwd, lt = graph_tables(g, sampler, model=model)
    out = ([], [])
    for half in (0, 1):
        kh = key.fold_in(half)
        for (s, salt) in slabs:
            _fire_fault(plan, "sampler.slab_fill", half=half, slab=s,
                        salt=salt)
            out[half].append(sample_incidence(
                nbr, prob, wt, kh.fold_in(s).fold_in(salt), theta=slab, n=n,
                model=model, max_steps=max_steps, sampler=sampler, fwd=fwd,
                coin_chunk=coin_chunk, lt=lt))
    return out


def make_pool(g: CSRGraph, key: Key, *, theta: int = 0, slab: int = 256,
              model: str = "IC", sampler: str = "kernel",
              coin_chunk: int = 32, max_steps: int = 32,
              plan: Optional[FaultPlan] = None) -> SketchPool:
    """A pool with ``theta`` samples per half (rounded up to whole
    slabs; 0 = empty, the first ``refresh`` fills it)."""
    if slab % bitset.WORD_BITS != 0 or slab < bitset.WORD_BITS:
        raise ValueError(f"slab must be a positive multiple of "
                         f"{bitset.WORD_BITS}, got {slab}")
    resolve_sampler(sampler)
    theta = _round_to_slabs(theta, slab)
    num_slabs = theta // slab
    n = g.num_vertices
    if num_slabs == 0:
        empty = torch.zeros((n, 0), dtype=bitset.WORD_DTYPE, device=g.device)
        return SketchPool(g, empty, empty, 0, 0, np.zeros((0,), np.int32),
                          key, slab, model, sampler, coin_chunk, max_steps)
    blocks1, blocks2 = _sample_slabs(
        g, key, [(s, 0) for s in range(num_slabs)], slab=slab, model=model,
        sampler=sampler, coin_chunk=coin_chunk, max_steps=max_steps,
        plan=plan)
    w = bitset.num_words(theta)
    r1 = torch.cat(blocks1, 1)[:, :w]
    r2 = torch.cat(blocks2, 1)[:, :w]
    return SketchPool(g, r1, r2, theta, 0, np.zeros((num_slabs,), np.int32),
                      key, slab, model, sampler, coin_chunk, max_steps)


def refresh(pool: SketchPool, new_theta: Optional[int] = None, *,
            max_theta: int = 1 << 20,
            plan: Optional[FaultPlan] = None) -> SketchPool:
    """Grow the pool to ``new_theta`` samples per half (default: double,
    at least one slab), appending slabs salted with the new generation;
    existing columns are kept bit for bit.  Returns a NEW pool with
    ``generation + 1``; the old one stays valid for draining."""
    if new_theta is None:
        new_theta = max(pool.theta * 2, pool.slab)
    new_theta = min(_round_to_slabs(new_theta, pool.slab), max_theta)
    if new_theta <= pool.theta:
        raise ValueError(
            f"refresh must grow the pool: theta {pool.theta} -> "
            f"{new_theta} (max_theta {max_theta})")
    gen = pool.generation + 1
    old_slabs = pool.theta // pool.slab
    num_slabs = new_theta // pool.slab
    blocks1, blocks2 = _sample_slabs(
        pool.g, pool.key, [(s, gen) for s in range(old_slabs, num_slabs)],
        slab=pool.slab, model=pool.model, sampler=pool.sampler,
        coin_chunk=pool.coin_chunk, max_steps=pool.max_steps, plan=plan)
    r1 = torch.cat([pool.r1] + blocks1, 1)
    del blocks1
    r2 = torch.cat([pool.r2] + blocks2, 1)
    salt = np.concatenate([pool.salt, np.full((num_slabs - old_slabs,), gen,
                                              np.int32)])
    return pool._replace(r1=r1, r2=r2, theta=new_theta, generation=gen,
                         salt=salt)


def affected_slabs(pool: SketchPool, touched) -> np.ndarray:
    """Slab indices whose samples (in either half) contain a touched
    vertex — the invalidation set of a graph mutation."""
    touched = torch.as_tensor(np.asarray(list(touched), dtype=np.int64),
                              device=pool.r1.device)
    if touched.numel() == 0 or pool.theta == 0:
        return np.zeros((0,), np.int64)
    words_hit = (pool.r1[touched] | pool.r2[touched]).ne(0).any(0)  # [W]
    per_slab = words_hit.reshape(-1, pool.slab // bitset.WORD_BITS).any(1)
    return torch.nonzero(per_slab)[:, 0].cpu().numpy()


def refresh_mutated(pool: SketchPool, g_new: CSRGraph, touched, *,
                    plan: Optional[FaultPlan] = None) -> SketchPool:
    """Apply a graph mutation incrementally: resample only the slabs
    whose samples contain a ``touched`` vertex, on the NEW graph with a
    fresh generation salt; every other column is kept bit for bit.
    Returns a NEW pool with ``generation + 1``."""
    if g_new.num_vertices != pool.n:
        raise ValueError("mutation must preserve the vertex set "
                         f"({pool.n} != {g_new.num_vertices})")
    gen = pool.generation + 1
    stale = affected_slabs(pool, touched)
    if pool.theta == 0 or stale.size == 0:
        return pool._replace(g=g_new, generation=gen)
    blocks1, blocks2 = _sample_slabs(
        g_new, pool.key, [(int(s), gen) for s in stale], slab=pool.slab,
        model=pool.model, sampler=pool.sampler, coin_chunk=pool.coin_chunk,
        max_steps=pool.max_steps, plan=plan)
    wps = pool.slab // bitset.WORD_BITS
    r1, r2 = pool.r1.clone(), pool.r2.clone()
    salt = pool.salt.copy()
    for i, s in enumerate(stale):
        r1[:, s * wps:(s + 1) * wps] = blocks1[i]
        r2[:, s * wps:(s + 1) * wps] = blocks2[i]
        salt[s] = gen
    return pool._replace(g=g_new, r1=r1, r2=r2, generation=gen, salt=salt)


# ---------------------------------------------------------------------
# Pool snapshot / restore (service recovery via checkpoint.store)
# ---------------------------------------------------------------------

# [theta, generation, slab, coin_chunk, max_steps, model_code,
#  sampler_code, typed_key_flag] — a fixed int64 leaf, so the snapshot
# tree has a fixed structure.
_POOL_SCALARS = 8


def pool_state(pool: SketchPool) -> dict:
    """The checkpointable state of a pool: key words, both halves, the
    slab salts and the static scalars (the graph is configuration,
    supplied again to :func:`pool_from_state`)."""
    try:
        model_code = _MODELS.index(pool.model)
        sampler_code = _SAMPLERS.index(pool.sampler)
    except ValueError:
        raise ValueError(
            f"cannot snapshot pool with model={pool.model!r} / "
            f"sampler={pool.sampler!r}; known models {_MODELS}, "
            f"samplers {_SAMPLERS}") from None
    scalars = np.asarray(
        [pool.theta, pool.generation, pool.slab, pool.coin_chunk,
         pool.max_steps, model_code, sampler_code, int(pool.typed_key)],
        np.int64)
    return {
        "key": np.asarray([pool.key.k0, pool.key.k1], np.uint32),
        "r1": pool.r1,
        "r2": pool.r2,
        "salt": np.asarray(pool.salt, np.int32),
        "scalars": scalars,
    }


def pool_template(g: CSRGraph) -> dict:
    """The tree structure :meth:`CheckpointStore.restore` fills (shapes
    come from the checkpoint files)."""
    del g  # the structure does not depend on the graph
    z = np.zeros((0,), np.uint32)
    return {"key": z, "r1": z, "r2": z, "salt": np.zeros((0,), np.int32),
            "scalars": np.zeros((_POOL_SCALARS,), np.int64)}


def _words_on(x, n: int, w: int, device) -> torch.Tensor:
    """Packed words (torch int32, or numpy of either signedness) as an
    int32 [n, w] tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(np.uint32).view(np.int32)))
    return x.to(device=device, dtype=bitset.WORD_DTYPE).reshape(n, w)


def pool_from_state(g: CSRGraph, state: dict) -> SketchPool:
    """Rebuild a :class:`SketchPool` on the graph's device from
    :func:`pool_state` output (possibly through a checkpoint)."""
    sc = [int(x) for x in np.asarray(state["scalars"]).reshape(-1)]
    if len(sc) != _POOL_SCALARS:
        raise ValueError(f"pool snapshot scalars must have "
                         f"{_POOL_SCALARS} entries, got {len(sc)}")
    (theta, gen, slab, coin_chunk, max_steps, model_code, sampler_code,
     typed) = sc
    kd = np.asarray(state["key"]).astype(np.uint64).reshape(-1)
    n, w = g.num_vertices, bitset.num_words(theta)
    salt = np.asarray(state["salt"], np.int32).reshape(
        theta // slab if theta else 0)
    return SketchPool(g, _words_on(state["r1"], n, w, g.device),
                      _words_on(state["r2"], n, w, g.device), theta, gen,
                      salt, Key(int(kd[0]), int(kd[1])), slab,
                      _MODELS[model_code], _SAMPLERS[sampler_code],
                      coin_chunk, max_steps, bool(typed))


def snapshot_pool(store, pool: SketchPool, *, step: Optional[int] = None,
                  blocking: bool = True) -> int:
    """Write the pool to a :class:`~repro_torch.checkpoint.store.CheckpointStore`
    (default step: the generation) and return the step.  Blocking by
    default: a recovery snapshot that silently failed is worse than a
    slow one."""
    step = pool.generation if step is None else step
    store.save(step, pool_state(pool), blocking=blocking)
    return step


def restore_pool(store, g: CSRGraph, *, step: Optional[int] = None):
    """The newest (or requested) pool snapshot as ``(pool, step)``, or
    ``(None, -1)`` when the store is empty."""
    tree, got = store.restore(pool_template(g), step=step, device=g.device)
    if tree is None:
        return None, -1
    return pool_from_state(g, tree), got


# ---------------------------------------------------------------------
# Batched query engine
# ---------------------------------------------------------------------

def per_query_state_bytes(words: int, k: int, excl: int) -> int:
    """Per-query solve state: covered words + k seed and gain slots + E
    exclusion slots.  The [n, W] pool is shared by the batch."""
    return 4 * words + 4 * k + 4 * k + 4 * excl


def _query_arrays(queries: Sequence[Query], n: int, theta: int):
    """(k_max, excl [B, E], ks [B], budget_cov [B]) of a batch."""
    if not queries:
        raise ValueError("empty query batch")
    for q in queries:
        if q.k < 1:
            raise ValueError(f"query k must be >= 1, got {q.k}")
        for v in q.excluded:
            if not (0 <= int(v) < n):
                raise ValueError(f"excluded id {v} out of range [0, {n})")
    k_max = max(q.k for q in queries)
    e_max = max(1, max(len(q.excluded) for q in queries))
    excl = np.full((len(queries), e_max), -1, np.int32)
    for b, q in enumerate(queries):
        if q.excluded:
            excl[b, :len(q.excluded)] = np.asarray(q.excluded, np.int32)
    ks = np.asarray([q.k for q in queries], np.int32)
    # Budget in coverage units: the smallest R1 coverage whose sketch
    # estimate (cov * n / theta) reaches the requested spread.
    budget_cov = np.asarray(
        [np.iinfo(np.int32).max if q.budget is None
         else int(math.ceil(q.budget * theta / n)) for q in queries],
        np.int32)
    return k_max, excl, ks, budget_cov


def _limits(ks, budget_cov, device):
    """The queries' k and budgets (host arrays [B]) as int64 tensors on
    the card.  Called after the solve is enqueued: a copy from pageable
    memory waits for the stream, so it returns once the solve has run
    (the end of the span ``service.solve``)."""
    return (torch.as_tensor(ks, dtype=torch.int64, device=device),
            torch.as_tensor(budget_cov, dtype=torch.int64, device=device))


def _finalize_batch(seeds, sel_rows, gains, ks, budget, r2):
    """Per query: budget/k truncation and R2 validation.  Greedy picks
    are prefix-consistent, so truncating a k_max solve at the query's k
    (or at the first pick whose cumulative coverage reaches the budget)
    equals solving with that k.  seeds/gains [B, k], sel_rows
    [B, k, W], ks/budget [B] (:func:`_limits`) -> (seeds_t, cov1, cov2,
    k_used)."""
    k = seeds.shape[1]
    dev = seeds.device
    reached = torch.cumsum(gains.to(torch.int64), 1) >= budget[:, None]
    first = reached.to(torch.int32).argmax(1) + 1
    jstar = torch.where(reached.any(1), first, ks).minimum(ks)
    use = torch.arange(k, device=dev)[None] < jstar[:, None]
    seeds_t = torch.where(use, seeds, -1)
    cov1 = bitset.coverage_size(bitset.or_reduce(
        torch.where(use[:, :, None], sel_rows, 0), axis=1))
    valid = seeds_t >= 0
    rows2 = r2[torch.where(valid, seeds_t, 0).long()]
    cov2 = bitset.coverage_size(bitset.or_reduce(
        torch.where(valid[:, :, None], rows2, 0), axis=1))
    return seeds_t, cov1, cov2, valid.sum(1)


def _answers(pool: SketchPool, queries: Sequence[Query], seeds_t, cov1,
             cov2, k_used, *, delta: float, alpha: float) -> list[Answer]:
    with span("service.read"):
        seeds_t = seeds_t.cpu().numpy()
        cov1, cov2 = cov1.cpu().numpy(), cov2.cpu().numpy()
        k_used = k_used.cpu().numpy()
    out = []
    with span("service.certify"):
        for b, q in enumerate(queries):
            c1, c2 = float(cov1[b]), float(cov2[b])
            sig_l, sig_u, guar = opim.certify(c1, c2, pool.theta, pool.n,
                                              delta, alpha)
            certified = guar >= alpha - q.eps or (
                q.budget is not None and sig_l >= q.budget)
            out.append(Answer(
                seeds=seeds_t[b][:q.k], k_used=int(k_used[b]),
                coverage=int(cov1[b]), spread=c1 * pool.n / pool.theta,
                sigma_lower=sig_l, sigma_upper=sig_u, guarantee=guar,
                certified=bool(certified), generation=pool.generation))
    return out


def answer_batch(pool: SketchPool, queries: Sequence[Query], *,
                 solver: str = "resident", delta: float = 1.0 / 128.0,
                 alpha: Optional[float] = None) -> list[Answer]:
    """Answer B concurrent queries with one batched solve over R1 at
    ``k_max = max(k)`` plus one batched truncation/validation.  Each
    answer equals :func:`answer_one`'s for the same query.  Its phases
    are the spans ``service.query_arrays``, ``.solve``, ``.finalize``,
    and :func:`_answers`' ``.read`` and ``.certify``."""
    if pool.theta == 0:
        raise EmptyPoolError(
            "sketch pool holds no samples; refresh it before answering "
            "(InfluenceService.admit does this automatically)")
    if alpha is None:
        alpha = 1.0 - 1.0 / math.e
    with span("service.query_arrays"):
        k_max, excl, ks, budget_cov = _query_arrays(queries, pool.n,
                                                    pool.theta)
    dev = pool.r1.device
    with span("service.solve"):
        sol = maxcover.greedy_maxcover_batch(
            pool.r1, torch.from_numpy(excl).to(dev), k_max, solver=solver)
        ks, budget = _limits(ks, budget_cov, dev)
    with span("service.finalize"):
        seeds_t, cov1, cov2, k_used = _finalize_batch(
            sol.seeds, sol.rows, sol.gains, ks, budget, pool.r2)
    return _answers(pool, queries, seeds_t, cov1, cov2, k_used,
                    delta=delta, alpha=alpha)


def answer_one(pool: SketchPool, query: Query, *, solver: str = "resident",
               delta: float = 1.0 / 128.0,
               alpha: Optional[float] = None) -> Answer:
    """Sequential reference: one un-batched solve at the query's own k.
    ``serve --check`` holds :func:`answer_batch` equal to this path."""
    if pool.theta == 0:
        raise EmptyPoolError("sketch pool holds no samples")
    if alpha is None:
        alpha = 1.0 - 1.0 / math.e
    _, excl, ks, budget_cov = _query_arrays([query], pool.n, pool.theta)
    sol = maxcover.greedy_maxcover(pool.r1, query.k, solver=solver,
                                   excluded=torch.from_numpy(excl[0]))
    seeds_t, cov1, cov2, k_used = _finalize_batch(
        sol.seeds[None], sol.rows[None], sol.gains[None],
        *_limits(ks, budget_cov, pool.r1.device), pool.r2)
    return _answers(pool, [query], seeds_t, cov1, cov2, k_used,
                    delta=delta, alpha=alpha)[0]


def estimate_spread(pool: SketchPool, seeds) -> float:
    """Sketch estimate of an explicit seed set's spread on R2 (one
    gather + popcount, no simulation)."""
    if pool.theta == 0:
        raise EmptyPoolError("sketch pool holds no samples")
    seeds = torch.as_tensor(np.asarray(seeds), device=pool.r2.device)
    return float(opim.coverage_on(pool.r2, seeds)) * pool.n / pool.theta


# ---------------------------------------------------------------------
# Service front-end: admission, generation drain, adaptive refresh
# ---------------------------------------------------------------------

class InfluenceService:
    """Serving front-end over a :class:`SketchPool`: the current pool
    plus draining predecessors.  ``admit`` tags a query with the current
    generation; ``answer`` batches tickets per generation and retires
    drained pools; ``serve`` is the full admission loop.

    ``stats`` (optional dict) accumulates the synchronized seconds and
    counts of the batched solves (``solve_s``, ``solves``) and of the
    refreshes (``refresh_s``, ``refreshes``).  Each batch's ``solve_s``
    clock is the span ``serve.solve``, with :func:`answer_batch`'s
    spans inside.
    """

    def __init__(self, g: CSRGraph, key: Key, *, theta0: int = 512,
                 max_theta: int = 1 << 14, slab: int = 256,
                 solver: str = "resident", model: str = "IC",
                 sampler: str = "kernel", coin_chunk: int = 32,
                 max_steps: int = 32, delta: float = 1.0 / 128.0,
                 alpha: Optional[float] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 stats: Optional[dict] = None):
        self._configure(solver=solver, theta0=theta0, max_theta=max_theta,
                        slab=slab, delta=delta, alpha=alpha,
                        fault_plan=fault_plan, stats=stats)
        pool = make_pool(g, key, theta=0, slab=slab, model=model,
                         sampler=sampler, coin_chunk=coin_chunk,
                         max_steps=max_steps, plan=fault_plan)
        self._pools: dict[int, SketchPool] = {0: pool}
        self._inflight: dict[int, int] = {0: 0}
        self._gen = 0

    def _configure(self, *, solver, theta0, max_theta, slab, delta, alpha,
                   fault_plan, stats):
        maxcover.resolve_solver(solver)
        self.solver = solver
        self.theta0 = _round_to_slabs(max(theta0, slab), slab)
        self.max_theta = _round_to_slabs(max_theta, slab)
        self.delta = delta
        self.alpha = alpha if alpha is not None else 1.0 - 1.0 / math.e
        self.fault_plan = fault_plan
        self.stats = stats

    @classmethod
    def from_pool(cls, pool: SketchPool, *, theta0: int = 512,
                  max_theta: int = 1 << 14, solver: str = "resident",
                  delta: float = 1.0 / 128.0, alpha: Optional[float] = None,
                  fault_plan: Optional[FaultPlan] = None,
                  stats: Optional[dict] = None) -> "InfluenceService":
        """A service around a restored pool (:func:`restore_pool`): it
        resumes at the pool's generation, and later refreshes continue
        the same salted-slab stream, so it answers as one that never
        stopped."""
        svc = cls.__new__(cls)
        svc._configure(solver=solver, theta0=theta0, max_theta=max_theta,
                       slab=pool.slab, delta=delta, alpha=alpha,
                       fault_plan=fault_plan, stats=stats)
        svc._pools = {pool.generation: pool}
        svc._inflight = {pool.generation: 0}
        svc._gen = pool.generation
        return svc

    @property
    def generation(self) -> int:
        return self._gen

    @property
    def pool(self) -> SketchPool:
        return self._pools[self._gen]

    def inflight(self, generation: Optional[int] = None) -> int:
        gen = self._gen if generation is None else generation
        return self._inflight.get(gen, 0)

    def _clock(self, name: str, layer: Optional[str] = None):
        return StageClock(self.stats, name, self.pool.g.device, layer=layer)

    def _count(self, name: str, n: int = 1):
        if self.stats is not None:
            self.stats[name] = self.stats.get(name, 0) + n

    # -- lifecycle ----------------------------------------------------

    def _install(self, pool: SketchPool):
        self._pools[pool.generation] = pool
        self._inflight.setdefault(pool.generation, 0)
        self._gen = pool.generation
        self._retire_drained()

    def _retire_drained(self):
        for gen in [g for g in self._pools
                    if g != self._gen and self._inflight.get(g, 0) == 0]:
            del self._pools[gen]
            self._inflight.pop(gen, None)

    def refresh(self, new_theta: Optional[int] = None):
        """Grow theta (default: double, first fill = theta0) under a new
        generation; drained generations retire, ones with in-flight
        tickets are kept for draining."""
        pool = self.pool
        if new_theta is None:
            new_theta = self.theta0 if pool.theta == 0 else min(
                pool.theta * 2, self.max_theta)
        with self._clock("refresh_s"):
            new = refresh(pool, new_theta, max_theta=self.max_theta,
                          plan=self.fault_plan)
        self._count("refreshes")
        self._install(new)

    def mutate(self, g_new: CSRGraph, touched):
        """Incremental refresh after a graph mutation (``touched`` =
        heads of inserted/deleted/re-weighted edges)."""
        with self._clock("refresh_s"):
            new = refresh_mutated(self.pool, g_new, touched,
                                  plan=self.fault_plan)
        self._count("refreshes")
        self._install(new)

    # -- admission / answering ---------------------------------------

    def admit(self, query: Query) -> Ticket:
        """Validate and tag a query with the current generation; an
        empty pool is filled (theta0) first."""
        if query.k < 1 or query.k > self.pool.n:
            raise ValueError(f"query k must be in [1, {self.pool.n}], "
                             f"got {query.k}")
        if query.budget is not None and query.budget > self.pool.n:
            raise ValueError(f"budget {query.budget} exceeds the vertex "
                             f"count {self.pool.n}")
        _fire_fault(self.fault_plan, "service.admit", k=query.k,
                    generation=self._gen)
        if self.pool.theta == 0:
            self.refresh()
        self._inflight[self._gen] += 1
        return Ticket(self._gen, query)

    def release(self, tickets: Sequence[Ticket]):
        """Abandon admitted tickets without answering them, so their
        generations can drain and retire."""
        for t in tickets:
            if t.generation in self._inflight:
                self._inflight[t.generation] = max(
                    0, self._inflight[t.generation] - 1)
        self._retire_drained()

    def answer(self, tickets: Sequence[Ticket]) -> list[Answer]:
        """Answer tickets in order; tickets of one generation share one
        batched solve on that generation's pool.  Stale generations and
        the injected fault raise before any in-flight count is consumed,
        so the batch can be retried whole."""
        _fire_fault(self.fault_plan, "service.answer", batch=len(tickets))
        for t in tickets:
            if t.generation not in self._pools:
                raise StaleGenerationError(
                    f"generation {t.generation} has been retired "
                    f"(current: {self._gen})")
        by_gen: dict[int, list[int]] = {}
        for i, t in enumerate(tickets):
            by_gen.setdefault(t.generation, []).append(i)
        out: list[Optional[Answer]] = [None] * len(tickets)
        for gen, idxs in by_gen.items():
            with self._clock("solve_s", "serve"):
                answers = answer_batch(
                    self._pools[gen], [tickets[i].query for i in idxs],
                    solver=self.solver, delta=self.delta, alpha=self.alpha)
            self._count("solves")
            for i, a in zip(idxs, answers):
                out[i] = a
            self._inflight[gen] -= len(idxs)
        self._retire_drained()
        return out  # type: ignore[return-value]

    def serve(self, queries: Sequence[Query], *,
              deadline_s: Optional[float] = None,
              clock: Callable[[], float] = time.monotonic) -> list[Answer]:
        """Answer the batch, then refresh and re-admit uncertified
        queries until they certify or ``max_theta`` is reached.  When
        the deadline (or ``max_theta``) cuts the loop, uncertified
        answers come back ``degraded=True`` with their honest bounds."""
        start = clock()
        tickets = [self.admit(q) for q in queries]
        answers = self.answer(tickets)
        while True:
            retry = [i for i, a in enumerate(answers) if not a.certified]
            if not retry:
                return answers
            out_of_time = (deadline_s is not None
                           and clock() - start >= deadline_s)
            if self.pool.theta >= self.max_theta or out_of_time:
                for i in retry:
                    answers[i] = answers[i]._replace(degraded=True)
                return answers
            self.refresh()
            redo = self.answer([self.admit(queries[i]) for i in retry])
            for i, a in zip(retry, redo):
                answers[i] = a


def answer_with_retry(service: InfluenceService, tickets: Sequence[Ticket],
                      *, retries: int = 3, backoff_s: float = 0.0,
                      sleep_fn: Callable[[float], None] = time.sleep
                      ) -> list[Answer]:
    """``service.answer`` with bounded retry: on
    :class:`StaleGenerationError` release the surviving tickets and
    re-admit every query on the current generation; on
    :class:`InjectedFault` retry as is (``answer`` raised before
    consuming any in-flight count).  Backoff ``backoff_s * 2**(attempt
    - 1)`` through ``sleep_fn``; re-raises the last error when the
    budget is spent."""
    tickets = list(tickets)
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt and backoff_s:
            sleep_fn(backoff_s * (2 ** (attempt - 1)))
        try:
            return service.answer(tickets)
        except StaleGenerationError as e:
            last = e
            service.release([t for t in tickets
                             if t.generation in service._pools])
            tickets = [service.admit(t.query) for t in tickets]
        except InjectedFault as e:
            last = e
    raise last  # type: ignore[misc]
