"""``check.py``'s IMM numbers with the reference's samples drawn over the
reverse CSR (``reference/csr_sampler.py``): for graphs whose padded
tables (``reference/sampler.py``'s ``Graph.cumw``) would not fit the
card.  The same numbers, limits and comparisons as ``check.imm_numbers``
(``sampler_off``, ``selection_off``); only the reference's draw is
another function of the same samples.
"""
from __future__ import annotations

import torch

from portbench import check
from portbench.reference import cover, csr_sampler
from portbench.reference import imm as ref_imm
from portbench.reference.threefry import Key


def reference_run(rg, cfg: dict, seed: int, unit: int, inc: cover.Entries,
                  precision: str = "float32"):
    """``check.reference_run`` with ``csr_sampler.draw``."""
    full = check.full_check(cfg)
    pairs = ([], [])

    def on_draw(d):
        if full:
            b, v = csr_sampler.draw(rg, d.key,
                                    torch.arange(d.count, device=rg.device),
                                    model=cfg["model"],
                                    max_steps=cfg["max_steps"],
                                    precision=precision)
            pairs[0].append(b + d.start)
            pairs[1].append(v)

    def own(words):
        return cover.from_pairs(torch.cat(pairs[0]), torch.cat(pairs[1]),
                                rg.n, words * 32)

    def select(words, sub):
        src = own(words) if full else inc.prefix(words)
        return cover.randgreedi(src, sub, m=cfg["machines"], k=cfg["k"],
                                delta=cfg["delta"], precision=precision)
    key = Key.from_seed(seed).fold_in(unit)
    draws, calls, result = ref_imm.imm(rg.n, cfg["k"], cfg["eps"], key,
                                       cfg["max_theta"], select, on_draw)
    calls = [(c.words, (c.key.k0, c.key.k1), c.seeds, c.coverage)
             for c in calls]
    return (draws, own(result.theta // 32) if full else None, calls,
            tuple(result))


def sampler_off(rg, cfg: dict, seed: int, unit: int, inc: cover.Entries,
                draws, own=None) -> int:
    """``check.sampler_off`` with ``csr_sampler.draw``."""
    theta = sum(d.count for d in draws)
    dev = inc.bits.device
    cols = None if own is not None else \
        check.check_columns(cfg, seed, unit, theta, dev)
    bad = []
    for d in draws:
        local = torch.arange(d.count, device=dev)
        roots = csr_sampler.roots(rg, d.key, local)
        bad.append((local + d.start)[~check.has_bit(inc, roots,
                                                    local + d.start)])
        if cols is None:
            continue
        local = cols[(cols >= d.start) & (cols < d.start + d.count)] \
            - d.start
        b, v = csr_sampler.draw(rg, d.key, local, model=cfg["model"],
                                max_steps=cfg["max_steps"])
        bad.append(check.differing((b + d.start, v),
                                   check.pairs_at(inc, local + d.start),
                                   rg.n))
    if own is not None:
        bad.append(check.differing(check.pairs_at(own), check.pairs_at(inc),
                                   rg.n))
    extra = inc.word >= theta // 32
    if bool(extra.any()):
        bad.append(check.pairs_at(cover.Entries(
            inc.row[extra], inc.word[extra], inc.bits[extra], inc.n,
            inc.words))[0])
    return int(torch.unique(torch.cat(bad)).numel())


def imm_numbers(rg, cfg: dict, seed: int, unit: int, inc: cover.Entries,
                calls, result) -> dict:
    """``check.imm_numbers`` over ``rg``, a ``csr_sampler.Graph``."""
    draws, own, ref_calls, ref_result = reference_run(rg, cfg, seed, unit,
                                                      inc)
    return {"sampler_off": sampler_off(rg, cfg, seed, unit, inc, draws, own),
            "selection_off": check.selection_off(ref_calls, ref_result, calls,
                                                 result)}
