"""Batches of seed queries over one resident pool: ``clients`` queries
at a time admitted to and answered by one ``InfluenceService`` (the
clients in a closed loop), the pool (``pool_theta`` samples a half in
slabs of ``slab``) filled in set-up, the queries drawn in set-up from
the seed with ``launch/serve.make_trace``'s mix.

The check (``check.py``): ``serve_off``, with the limit 0.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from portbench import check, counts, drive
from portbench.reference import sampler
from repro_torch.core import service


def draw_queries(n: int, traffic: dict, seed: int) -> list[service.Query]:
    """The query mix of ``launch/serve.make_trace``: k ~ U[1, k_max], 0 ..
    excl_max excluded vertices, a spread budget U[1, budget_frac n) with
    probability budget_prob."""
    rng = np.random.default_rng([int(seed), 0x5E77E])
    out = []
    for _ in range(traffic["queries"]):
        k = int(rng.integers(1, traffic["k_max"] + 1))
        e = int(rng.integers(0, traffic["excl_max"] + 1))
        excluded = tuple(int(v) for v in
                         rng.choice(n, size=e, replace=False)) if e else ()
        budget = (float(rng.uniform(1.0, traffic["budget_frac"] * n))
                  if rng.random() < traffic["budget_prob"] else None)
        out.append(service.Query(k=k, excluded=excluded, budget=budget,
                                 eps=traffic["eps"]))
    return out


class Entry(drive.Entry):
    LIMITS = {"serve_off": 0}

    @property
    def params(self) -> dict:
        """The configuration with the traffic's pool parameters."""
        return {**self.config, **self.traffic}

    def setup(self):
        super().setup()
        p = self.params
        self.queries = draw_queries(self.g.num_vertices, self.traffic,
                                    self.seed)
        self.svc = service.InfluenceService(
            self.g, drive.port_key(self.seed), theta0=p["pool_theta"],
            max_theta=p["pool_theta"], slab=p["slab"], solver=p["solver"],
            model=p["model"], sampler=p["sampler"],
            max_steps=p["max_steps"], delta=p["fail_prob"])

    def _batch(self, queries):
        with drive.span("batch", self.traced):
            with drive.span("admit", self.traced):
                tickets, t_in = [], []
                for q in queries:
                    t_in.append(time.perf_counter())
                    tickets.append(self.svc.admit(q))
            with drive.span("answer", self.traced):
                answers = self.svc.answer(tickets)
        t_out = time.perf_counter()
        return answers, [t_out - t for t in t_in]

    def warmup(self):
        """The pool's fill (the first admission) and one batch."""
        self._batch(self.queries[-self.traffic["clients"]:])

    def window(self, seconds: float) -> dict:
        self.svc.stats = self.stats
        b = self.traffic["clients"]
        self.asked, self.answers, latency, self.shapes = [], [], [], []
        t0 = time.perf_counter()
        while True:
            at = (self.units * b) % (len(self.queries) - b)
            batch = self.queries[at:at + b]
            answers, lat = self._batch(batch)
            self.asked += batch
            self.answers += answers
            latency += lat
            self.shapes.append((len(batch), max(q.k for q in batch),
                                max(1, max(len(q.excluded) for q in batch))))
            self.units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        pool = self.svc.pool
        print(f"[portbench] {len(self.answers)} queries in {self.units} "
              f"batches, pool theta {pool.theta} a half, W {pool.words}",
              flush=True)
        return {"queries_per_s": len(self.answers) / elapsed,
                "query_p95_s": float(np.percentile(latency, 95))}

    def requests(self):
        return len(self.asked), len(self.asked) - len(self.answers)

    def counts(self) -> dict:
        pool = self.svc.pool
        return {"query_bound_s": sum(
            counts.bound_s(counts.query_batch_bytes(
                pool.n, pool.words, bsz, k, e))
            for bsz, k, e in self.shapes)}

    def _reference_graph(self, dev):
        a = self.arrays
        return sampler.Graph(a.indptr, a.indices, a.probs, a.weights,
                             device=dev)

    def verify(self) -> dict:
        p = self.params
        pool = self.svc.pool
        halves = [check.entries_of(pool.r1), check.entries_of(pool.r2)]
        pick = check.sample_queries(len(self.asked), self.seed,
                                    p["check_queries"])
        asked = [self.asked[i] for i in pick]
        answers = [check.answer_fields(self.answers[i]) for i in pick]
        unanswered = len(self.asked) - len(self.answers)
        dev = self.g.device
        del pool, self.svc, self.g
        drive.free(dev)
        rg = self._reference_graph(dev)
        ref = check.pool_entries(rg, p, self.seed, p["fill_generation"])
        numbers, parts = check.serve_numbers(
            ref, halves, check.reference_answers(ref, asked, p), answers,
            unanswered)
        print(" ".join(f"{k} {v}" for k, v in parts.items()),
              file=sys.stderr)
        return numbers

    def control(self, seconds: float = 5.0) -> tuple[dict, dict]:
        """A short window -> (the program's numbers, the control's): the
        reference's pool and answers one precision below float32 in the
        program's place."""
        p, low = self.params, check.LOW
        self.warmup()
        self.window(seconds)
        dev = self.g.device
        program = self.verify()
        rg = self._reference_graph(dev)
        ref = check.pool_entries(rg, p, self.seed, p["fill_generation"])
        ctrl = check.pool_entries(rg, p, self.seed, p["fill_generation"],
                                  precision=low)
        queries = draw_queries(rg.n, self.traffic, self.seed)
        pick = check.sample_queries(len(queries), self.seed,
                                    p["check_queries"])
        asked = [queries[i] for i in pick]
        control, parts = check.serve_numbers(
            ref, ctrl, check.reference_answers(ref, asked, p),
            check.reference_answers(ctrl, asked, p, precision=low), 0)
        return program, dict(control, **parts)
