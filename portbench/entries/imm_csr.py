"""Back-to-back ``repro_torch.core.imm.imm`` selections as
``entries/imm.py`` drives them, checked against the reference's samples
drawn over the reverse CSR (``check_csr.py``, ``reference/
csr_sampler.py``), which holds no [n, d] table: for graphs whose rows
padded to the largest in-degree would not fit the card.

The check compares the window's last selection, with ``imm``'s numbers
and limits: ``sampler_off`` and ``selection_off``, each 0.
"""
from __future__ import annotations

import torch

from portbench import check, check_csr, lookup
from portbench.reference import csr_sampler

_imm = lookup.module("entries", "imm")


class Entry(_imm.Entry):
    def _taken(self):
        inc, calls, result, rg = super()._taken()
        a = self.arrays
        return inc, calls, result, csr_sampler.Graph(
            a.indptr, a.indices, a.probs, a.weights, device=rg.device)

    def verify(self) -> dict:
        inc, calls, result, rg = self._taken()
        return check_csr.imm_numbers(rg, self.config, self.seed,
                                     self.units - 1, inc, calls, result)

    def control(self, seconds: float = 0.0) -> tuple[dict, dict]:
        """``imm``'s control over the CSR reference: one selection (unit
        0) -> (the program's numbers, those of the reference one
        precision below float32 in the program's place)."""
        cfg, low = self.config, check.LOW
        self.result = self.one(self.base.fold_in(0))
        self.units = 1
        inc, calls, result, rg = self._taken()
        program = check_csr.imm_numbers(rg, cfg, self.seed, 0, inc, calls,
                                        result)
        if check.full_check(cfg):
            _, ctrl, c_calls, c_res = check_csr.reference_run(
                rg, cfg, self.seed, 0, None, precision=low)
        else:
            draws, _, _, _ = check_csr.reference_run(rg, cfg, self.seed, 0,
                                                     inc)
            theta = sum(d.count for d in draws)
            cols = check.check_columns(cfg, self.seed, 0, theta,
                                       inc.bits.device)
            bs, vs = [], []
            for d in draws:
                local = cols[(cols >= d.start) & (cols < d.start + d.count)] \
                    - d.start
                b, v = csr_sampler.draw(rg, d.key, local, model=cfg["model"],
                                        max_steps=cfg["max_steps"],
                                        precision=low)
                bs.append(b + d.start)
                vs.append(v)
            ctrl = _imm.substitute(inc, cols, torch.cat(bs), torch.cat(vs))
            _, _, c_calls, c_res = check_csr.reference_run(
                rg, cfg, self.seed, 0, ctrl, precision=low)
        return program, check_csr.imm_numbers(rg, cfg, self.seed, 0, ctrl,
                                              c_calls, c_res)
