"""Each cell end to end on the CPU (the look for a chip skipped, the
device passed explicitly); the same runs with the timed path broken
underneath come out not correct; and the control, the reference one
precision below float32 in the program's place, is not correct."""
import json
import time

import pytest
import torch

from portbench import control, harness
from portbench.conftest import SMALL, small_cell
from repro_torch.core import randgreedi, rrr, service
from repro_torch.core import imm as port_imm

SEED = 2**31 + 77


def _run(cell, traced=False):
    return harness.run(cell, SEED, 0.2, traced, "cpu", time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
def test_a_cell_runs_end_to_end_on_the_cpu(cell_name, traced):
    cell = small_cell(cell_name)
    out = _run(cell, traced)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checked"
    assert all(v["value"] == 0 for v in out["checked"].values())
    if traced:
        # the CPU has no device trace: only the program's stats read
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert out["metrics"]
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for name, m in out["metrics"].items()
                   if name != "peak_device_gib")
    json.dumps(out)


def _step_unchanged(monkeypatch):
    """Every BFS step returns its state unchanged (no vertex reached)."""
    for model in ("IC", "LT"):
        monkeypatch.setitem(rrr._PUSH, model, lambda *a: None)


def _half_of_the_samples(monkeypatch):
    """The sampler fills half of its samples; the rest stay empty."""
    draw = port_imm.sample_incidence

    def half(*a, **kw):
        out = draw(*a, **kw)
        out[:, out.shape[1] // 2:] = 0
        return out
    monkeypatch.setattr(port_imm, "sample_incidence", half)


def _seed_altered(monkeypatch):
    """RandGreedi's first seed altered where it is produced."""
    solve = randgreedi.randgreedi_maxcover

    def altered(rows, *a, **kw):
        res = solve(rows, *a, **kw)
        seeds = res.seeds.clone()
        seeds[0] = (seeds[0] + 1) % rows.shape[0]
        return res._replace(seeds=seeds)
    monkeypatch.setattr(randgreedi, "randgreedi_maxcover", altered)


def _half_of_the_batch(monkeypatch):
    """A batch solved for its first half, the rest given those answers."""
    answer = service.answer_batch

    def half(pool, queries, **kw):
        out = answer(pool, queries[:max(1, len(queries) // 2)], **kw)
        return (out * len(queries))[:len(queries)]
    monkeypatch.setattr(service, "answer_batch", half)


def _answer_altered(monkeypatch):
    """Each batch's first answer's coverage altered where it is made."""
    make = service._answers

    def altered(*a, **kw):
        out = make(*a, **kw)
        out[0] = out[0]._replace(coverage=out[0].coverage + 1)
        return out
    monkeypatch.setattr(service, "_answers", altered)


# the faults each kind of cell can have; it has no exchange between
# chips, every cell running on one
FAULTS = {"imm": [_step_unchanged, _half_of_the_samples, _seed_altered],
          "serve": [_step_unchanged, _half_of_the_batch, _answer_altered]}
CASES = [(cell, fault) for cell in sorted(SMALL)
         for fault in FAULTS[cell.rsplit(".", 1)[1]]]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for v in out["checked"].values())


# shapes at which the bfloat16 roundings change draws and picks
CONTROL = {"g500_ic.imm": dict(edgefactor=16),
           "g500_lt.imm": {},
           "g500_lt.serve": dict(edgefactor=16)}
CONTROL_TRAFFIC = {"g500_lt.serve": dict(pool_theta=1024, slab=128)}


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_the_control_is_not_correct(name):
    cell = small_cell(name, **CONTROL[name])
    cell.traffic.update(CONTROL_TRAFFIC.get(name, {}))
    program, ctrl = control.readings(cell, SEED, "cpu", seconds=0.1)
    assert all(v == 0 for v in program.values())
    compared = {k: v for k, v in ctrl.items() if k in program}
    assert any(v > 0 for v in compared.values()), ctrl


def test_substitute_replaces_the_chosen_samples_only():
    from portbench import check, lookup
    from portbench.reference import cover
    inc = cover.from_pairs(torch.tensor([0, 1, 33, 40]),
                           torch.tensor([2, 2, 0, 1]), 3, 64)
    out = lookup.module("entries", "imm").substitute(inc, torch.tensor([1, 33]),
                             torch.tensor([33]), torch.tensor([2]))
    s, v = check.pairs_at(out)
    assert sorted(zip(s.tolist(), v.tolist())) == [(0, 2), (33, 2), (40, 1)]
