"""Back-to-back ``repro_torch.core.imm.imm`` selections: one analyst in
a closed loop, selection i keyed ``key(seed).fold_in(i)``, the selector
built as ``launch/im_driver.py`` builds it for ``--selector greediris``
(RandGreedi over the configuration's m machines, the traffic's
aggregator, solver and kernel flags).

The check compares the window's last selection (``check.py``):
``sampler_off`` and ``selection_off``, each with the limit 0.
"""
from __future__ import annotations

import time

import torch

from portbench import check, counts, drive
from portbench.reference import cover, sampler
from portbench.reference import imm as ref_imm
from repro_torch.core import imm as port_imm

M32 = drive.M32


class Entry(drive.Entry):
    LIMITS = {"sampler_off": 0, "selection_off": 0}

    def setup(self):
        super().setup()
        c, t = self.config, self.traffic
        self.selector = port_imm.make_randgreedi_selector(
            c["machines"], t["aggregator"], c["delta"],
            use_kernel=t["use_kernel"], solver=t["solver"])
        self.base = drive.port_key(self.seed)
        self.calls = []         # (words, key, seeds, coverage) this unit
        self.rows = None        # the incidence of the unit's last call
        self.shapes = []        # (rows, words) of every call in the window

    def _select(self, rows, k, key):
        self.rows = rows
        with drive.span("selector", self.traced):
            seeds, cov = self.selector(rows, k, key)
            if self.traced:
                drive.sync(self.device)
        self.calls.append((rows.shape[1], key, seeds, cov))
        return seeds, cov

    def one(self, key):
        self.calls, self.rows = [], None
        c, t = self.config, self.traffic
        with drive.span("selection", self.traced):
            return port_imm.imm(
                self.g, c["k"], c["eps"], key, model=c["model"],
                selector=self._select, max_theta=c["max_theta"],
                max_steps=c["max_steps"], sampler=t["sampler"],
                gather=t["gather"], stats=self.stats)

    def warmup(self):
        self.one(self.base.fold_in(M32))
        self.calls, self.rows = [], None
        if self.stats is not None:
            self.stats.clear()

    def window(self, seconds: float) -> dict:
        self.shapes = []
        t0 = time.perf_counter()
        while True:
            self.result = self.one(self.base.fold_in(self.units))
            self.units += 1
            m = self.config["machines"]
            n_pad = -(-self.g.num_vertices // m) * m
            self.shapes += [(n_pad, w) for w, *_ in self.calls]
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        res, c = self.result, self.config
        n = self.g.num_vertices
        own = ref_imm.ceil32(ref_imm.lambda_star(
            n, c["k"], c["eps"], ref_imm.adjust_ell(n, 1.0)) / res.lb)
        print(f"[portbench] {self.units} selections, theta {res.theta} "
              f"(IMM's own at this LB {res.lb:.1f}: {own}), rounds "
              f"{res.rounds}, {len(self.calls)} selector calls each",
              flush=True)
        return {"selection_s": elapsed / self.units}

    def requests(self):
        return self.units, 0

    def counts(self) -> dict:
        """The bounds of the window's work: the selector calls' bytes,
        and for IC the last selection's sampling."""
        out = {"select_bound_s": sum(
            counts.bound_s(counts.select_bytes(r, w, self.config["k"]))
            for r, w in self.shapes)}
        if self.config["model"] == "IC" and self.rows is not None:
            slots = torch.from_numpy(counts.live_slots(
                self.arrays.indptr, self.arrays.probs)).to(self.rows.device)
            out["sampler_bound_s_last"] = counts.sampler_bound_s(
                counts.coins(self.rows, slots),
                self.rows.numel() * counts.WORD_BYTES)
        return out

    def _taken(self):
        """What the last selection produced, on the host or as entries,
        and the program's state freed -> (incidence, calls, result,
        reference graph)."""
        inc = check.entries_of(self.rows)
        calls = [(w, (key.k0, key.k1),
                  tuple(int(s) for s in seeds.tolist()), int(cov))
                 for w, key, seeds, cov in self.calls]
        res = self.result
        result = (tuple(int(s) for s in res.seeds), res.coverage_fraction,
                  res.theta, res.rounds, res.lb)
        dev = self.g.device
        del self.rows, self.calls, self.g, self.selector
        drive.free(dev)
        a = self.arrays
        rg = sampler.Graph(a.indptr, a.indices, a.probs, a.weights,
                           device=dev)
        return inc, calls, result, rg

    def verify(self) -> dict:
        inc, calls, result, rg = self._taken()
        return check.imm_numbers(rg, self.config, self.seed, self.units - 1,
                                 inc, calls, result)

    def control(self, seconds: float = 0.0) -> tuple[dict, dict]:
        """One selection (unit 0) -> (the program's numbers, the
        control's): the reference one precision below float32 in the
        program's place.  Where the check draws every sample the control
        draws every sample and selects over its own incidence; otherwise
        its RRR sets replace the checked samples of the program's
        incidence, and its RandGreedi and rounds over that incidence
        replace the program's selections."""
        cfg, low = self.config, check.LOW
        self.result = self.one(self.base.fold_in(0))
        self.units = 1
        inc, calls, result, rg = self._taken()
        program = check.imm_numbers(rg, cfg, self.seed, 0, inc, calls,
                                    result)
        if check.full_check(cfg):
            _, ctrl, c_calls, c_res = check.reference_run(
                rg, cfg, self.seed, 0, None, precision=low)
        else:
            draws, _, _, _ = check.reference_run(rg, cfg, self.seed, 0, inc)
            theta = sum(d.count for d in draws)
            cols = check.check_columns(cfg, self.seed, 0, theta,
                                       inc.bits.device)
            bs, vs = [], []
            for d in draws:
                local = cols[(cols >= d.start) & (cols < d.start + d.count)] \
                    - d.start
                b, v = sampler.draw(rg, d.key, local, model=cfg["model"],
                                    max_steps=cfg["max_steps"],
                                    precision=low)
                bs.append(b + d.start)
                vs.append(v)
            ctrl = substitute(inc, cols, torch.cat(bs), torch.cat(vs))
            _, _, c_calls, c_res = check.reference_run(
                rg, cfg, self.seed, 0, ctrl, precision=low)
        return program, check.imm_numbers(rg, cfg, self.seed, 0, ctrl,
                                          c_calls, c_res)


def substitute(inc: cover.Entries, cols, sample, vertex) -> cover.Entries:
    """``inc`` with the samples ``cols`` replaced by the sets {(sample,
    vertex)}."""
    repl = cover.from_pairs(sample, vertex, inc.n, inc.words * 32)
    mask = torch.zeros(inc.words, dtype=torch.int64, device=inc.bits.device)
    mask.index_add_(0, cols // 32, torch.ones_like(cols) << (cols % 32))
    w = inc.words
    code = torch.cat([inc.row * w + inc.word, repl.row * w + repl.word])
    bits = torch.cat([inc.bits & ~mask[inc.word], repl.bits])
    uniq, inv = torch.unique(code, return_inverse=True)
    out = torch.zeros(uniq.shape, dtype=torch.int64, device=bits.device)
    out.index_add_(0, inv, bits)
    keep = out != 0
    return cover.Entries(uniq[keep] // w, uniq[keep] % w, out[keep],
                         inc.n, w)
