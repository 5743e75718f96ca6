"""Port parity: the fault plans (``runtime.faults``) accept and reject
what the reference's do, fire the same sequence, and write the same
report; the resilient round (``resilient_randgreedi``) drops, poisons,
retries and shrinks alpha as the reference's does, with the same
survivors and the same seeds, coverage and cover (tolerance zero) on the
same rows, over every solver."""
import argparse
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitset as ref_bitset  # noqa: E402
from repro.runtime import faults as ref  # noqa: E402
from repro.runtime.fault_tolerance import \
    StragglerMonitor as RefMonitor  # noqa: E402
from repro_torch.core import bitset, maxcover, randgreedi  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerMonitor  # noqa: E402
from tests.test_torch_ref import (partitionable, port_key,  # noqa: E402,F401
                                  to_port, u32)

SPECS = [
    "service.answer:raise:1", "local.greedy:delay:2:0.05",
    "checkpoint.write:write_fail", "local.greedy:nan:3",
    "local.greedy:drop", "sampler.slab_fill:raise:0",
    "service.admit:delay:4:1.5", "receiver.insert:raise:2",
    # rejected: arity, site, kind, kind at site, occurrence, arg
    "local.greedy", "a:b:c:d:e", "bogus.site:raise", "local.greedy:explode",
    "service.answer:drop", "local.greedy:write_fail",
    "local.greedy:delay:x", "local.greedy:delay:0:y",
    "local.greedy:drop:-1", "local.greedy:delay:0:-2",
]


def _outcome(mod, text):
    try:
        return ("ok", tuple(vars(mod.parse_fault(text)).values()))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("text", SPECS)
def test_parse_fault_accepts_and_rejects_as_reference(text):
    assert _outcome(faults, text) == _outcome(ref, text)
    try:
        want = ("ok", tuple(vars(ref.cli_fault_arg(text)).values()))
    except argparse.ArgumentTypeError as e:
        want = ("error", str(e))
    try:
        got = ("ok", tuple(vars(faults.cli_fault_arg(text)).values()))
    except argparse.ArgumentTypeError as e:
        got = ("error", str(e))
    assert got == want


def test_tables_match_reference():
    assert faults.SITES == ref.SITES
    assert faults.FAULT_KINDS == ref.FAULT_KINDS
    assert faults.KIND_SITES == ref.KIND_SITES


def _run_plan(mod, probes):
    """Fire ``probes`` (sites) through a plan of mod; record what each
    probe did and what the plan slept."""
    sleeps = []
    plan = mod.FaultPlan(
        [mod.FaultSpec("service.answer", "raise", at=1),
         mod.FaultSpec("service.answer", "delay", at=2, arg=0.5),
         mod.FaultSpec("local.greedy", "drop", at=0),
         mod.FaultSpec("local.greedy", "nan", at=2),
         mod.FaultSpec("checkpoint.write", "write_fail", at=1)],
        sleep_fn=sleeps.append)
    out = []
    for i, site in enumerate(probes):
        try:
            spec = plan.fire(site, probe=i)
            out.append(None if spec is None else (spec.kind, spec.at))
        except mod.InjectedFault as e:
            out.append(("raised", e.site, e.kind, e.occurrence, str(e)))
    return out, sleeps, plan.events, plan.report(), \
        {s: plan.occurrences(s) for s in mod.SITES}


def test_plan_fires_the_same_sequence():
    probes = (["service.answer"] * 4 + ["local.greedy"] * 3
              + ["checkpoint.write"] * 2 + ["service.admit"])
    assert _run_plan(faults, probes) == _run_plan(ref, probes)
    assert faults.fire(None, "service.answer") is None
    with pytest.raises(ValueError, match="unknown injection site"):
        faults.FaultPlan().fire("not.a.site")
    with pytest.raises(TypeError):
        faults.FaultPlan(["service.answer:raise"])


def test_fault_report_matches_reference(tmp_path):
    def report(mod, path):
        inner = mod.FaultReport()
        inner.check("sub", True)
        inner.write(str(path / f"{mod.__name__}.inner.json"))
        rep = mod.FaultReport()
        rep.check("good", True, n=3)
        rep.merge_file(str(path / f"{mod.__name__}.inner.json"))
        plan = mod.FaultPlan([mod.FaultSpec("service.admit", "raise")])
        with pytest.raises(mod.InjectedFault):
            plan.fire("service.admit", k=2)
        rep.add_events(plan)
        rep.check("bad", False, detail=42)
        rep.write(str(path / f"{mod.__name__}.json"))
        return rep.ok, open(path / f"{mod.__name__}.json").read()
    got, want = report(faults, tmp_path), report(ref, tmp_path)
    assert got == want and got[0] is False
    assert json.loads(got[1])["merged"][0]["pass"] is True


# ---------------------------------------------------------------------
# The resilient round, against the reference's on the same rows
# ---------------------------------------------------------------------

M, K = 4, 6
SOLVERS = ("scan", "fused", "resident", "lazy")


@pytest.fixture(scope="module")
def ref_rows():
    rng = np.random.default_rng(7)
    dense = rng.random((64, 256)) < 0.08
    return np.array(ref_bitset.pack_bool_matrix(jnp.asarray(dense)))


def _key():
    return jax.random.key(3)


def _specs(mod, plan):
    return [mod.FaultSpec(*spec) for spec in plan]


def _result(res):
    return (u32(res.seeds).astype(np.int32).tolist(), int(res.coverage),
            u32(res.covered).tolist())


def _both(ref_rows, plan, *, solver="scan", **kw):
    """(port, reference) outcomes of the resilient round under ``plan``
    (``(site, kind, at[, arg])`` tuples): (result, survivors, alpha) or
    the name of the error raised."""
    out = []
    for mod, rows, key, extra in (
            (faults, to_port(ref_rows), port_key(_key()),
             dict(solver=solver)), (ref, jnp.asarray(ref_rows), _key(), {})):
        try:
            res, surv, alpha = mod.resilient_randgreedi(
                rows, key, m=M, k=K, plan=mod.FaultPlan(_specs(mod, plan)),
                **kw, **extra)
            out.append((_result(res), surv, alpha))
        except (mod.PartitionsLostError, mod.InjectedFault) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("plan,survivors", [
    ([("local.greedy", "drop", 2)], (0, 1, 3)),
    ([("local.greedy", "raise", 0)], (1, 2, 3)),
    ([("local.greedy", "nan", 3)], (0, 1, 2)),
    ([("local.greedy", "drop", 1), ("local.greedy", "nan", 2),
      ("local.greedy", "delay", 0, 0.0)], (0, 3)),
    ([("receiver.insert", "raise", 0)], (0, 1, 2, 3)),
    ([("local.greedy", "drop", 0), ("receiver.insert", "raise", 0),
      ("receiver.insert", "raise", 1)], (1, 2, 3)),
])
def test_faulted_round_matches_reference(ref_rows, solver, plan, survivors):
    """Drop, raise and nan kill a machine, a delay does not, and an
    injected merge raise is retried: the same survivors and the same
    seeds, coverage and cover as the reference's round, which equal a
    clean round on the survivors alone."""
    got, want = _both(ref_rows, plan, solver=solver)
    assert got == want
    assert got[1] == survivors and got[2] == 1.0
    clean = randgreedi.randgreedi_maxcover(
        to_port(ref_rows), port_key(_key()), m=M, k=K, survivors=survivors)
    assert got[0] == _result(clean)


def test_raise_kills_machine_like_drop(ref_rows):
    by_raise = _both(ref_rows, [("local.greedy", "raise", 0)])
    by_drop = _both(ref_rows, [("local.greedy", "drop", 0)])
    assert by_raise == by_drop and by_raise[0][1] == (1, 2, 3)


def test_m_independence_of_lost_partition(ref_rows):
    """Corrupting the dropped partition's rows changes nothing."""
    plan = [("local.greedy", "drop", 1)]
    blocks = randgreedi.partition_blocks(ref_rows.shape[0], M,
                                         port_key(_key()))
    garbage = ref_rows.copy()
    garbage[blocks[1]] = 0xFFFFFFFF
    got = _both(garbage, plan, solver="lazy")
    assert got[0] == got[1] == _both(ref_rows, plan, solver="lazy")[0]


@pytest.mark.parametrize("solver", ["scan", "lazy"])
def test_all_partitions_lost_raises(ref_rows, solver):
    plan = [("local.greedy", "drop", j) for j in range(M)]
    assert _both(ref_rows, plan, solver=solver) == [
        "PartitionsLostError"] * 2


def test_merge_retry_budget(ref_rows):
    """Past the retry budget the injected merge fault surfaces."""
    plan = [("receiver.insert", "raise", j) for j in range(3)]
    assert _both(ref_rows, plan, merge_retries=2) == ["InjectedFault"] * 2
    got = _both(ref_rows, plan, merge_retries=3)
    assert got[0] == got[1] and got[0][1] == (0, 1, 2, 3)


@pytest.mark.parametrize("solver", ["scan", "resident"])
def test_straggler_delay_shrinks_alpha(ref_rows, solver):
    """Injected delays (recorded, never slept) and a fake clock trip the
    StragglerMonitor: alpha halves, no machine dies, and the truncated
    merge equals the reference's."""
    def run(mod, monitor_cls, rows, key, **kws):
        sleeps = []
        plan = mod.FaultPlan(
            [mod.FaultSpec("local.greedy", "delay", at=j, arg=0.01)
             for j in (3, 4, 5)], sleep_fn=sleeps.append)
        ticks, t = [], 0.0
        for d in (1.0, 1.0, 1.0, 1e3, 1e6, 1e9):   # 3 escalating outliers
            ticks.extend((t, t + d))
            t += d + 1.0
        it = iter(ticks)
        mon = monitor_cls()
        res, survivors, alpha = mod.resilient_randgreedi(
            rows, key, m=6, k=K, plan=plan, monitor=mon, alpha_trunc=1.0,
            clock=lambda: next(it), **kws)
        return (_result(res), survivors, alpha, mon.flags, sleeps,
                plan.events)
    got = run(faults, StragglerMonitor, to_port(ref_rows), port_key(_key()),
              solver=solver)
    want = run(ref, RefMonitor, jnp.asarray(ref_rows), _key())
    assert got == want
    assert len(got[1]) == 6 and got[3] >= 3 and got[2] == 0.5
    assert got[4] == [0.01] * 3


def test_survivor_seeds_come_from_surviving_partitions(ref_rows):
    survivors = (0, 2)
    rows, key = to_port(ref_rows), port_key(_key())
    res = randgreedi.randgreedi_maxcover(rows, key, m=M, k=K,
                                         survivors=survivors)
    blocks = randgreedi.partition_blocks(rows.shape[0], M, key)
    allowed = set(blocks[list(survivors)].reshape(-1).tolist())
    seeds = res.seeds.numpy()
    assert set(seeds[seeds >= 0].tolist()) <= allowed
    assert int(res.coverage) > 0
    assert int(bitset.coverage_size(res.covered)) == int(res.coverage)
    plan = [("local.greedy", "drop", 1), ("local.greedy", "drop", 3)]
    got, want = _both(ref_rows, plan, solver="resident")
    assert got == want and got[0] == _result(res)


def test_survivors_greedy_aggregator_matches_manual(ref_rows):
    """Greedy-aggregated survivors == aggregating the surviving machines'
    local picks by hand."""
    survivors = (1, 3)
    rows, key = to_port(ref_rows), port_key(_key())
    res = randgreedi.randgreedi_maxcover(rows, key, m=M, k=K,
                                         aggregator="greedy",
                                         survivors=survivors, solver="scan")
    blocks = randgreedi.partition_blocks(rows.shape[0], M, key)
    sent_rows, local_cov = [], []
    for j in survivors:
        sol = maxcover.greedy_maxcover(
            rows[torch.from_numpy(blocks[j]).long()], K, solver="scan")
        sent_rows.append(sol.rows)
        local_cov.append(int(sol.coverage))
    agg = maxcover.greedy_maxcover(torch.cat(sent_rows), K, solver="scan")
    assert int(res.coverage) == max(int(agg.coverage), max(local_cov))


def test_retried_merge_frees_its_rows(ref_rows):
    """A retried merge keeps no reference cycle through the caught
    fault's traceback: the rows go when the caller drops them, without
    waiting for the cycle collector (on the card they are gigabytes)."""
    import gc
    import weakref
    rows = to_port(ref_rows).clone()
    alive = weakref.ref(rows)
    plan = faults.FaultPlan([faults.FaultSpec("receiver.insert", "raise",
                                              at=0)])
    gc.disable()
    try:
        res = faults.resilient_randgreedi(rows, port_key(_key()), m=M, k=K,
                                          plan=plan, solver="lazy")
        del rows, res
        assert alive() is None
    finally:
        gc.enable()
