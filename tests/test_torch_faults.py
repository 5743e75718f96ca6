"""Port parity: the fault plans (``runtime.faults``) accept and reject
what the reference's do, fire the same sequence, and write the same
report."""
import argparse
import json

import pytest

pytest.importorskip("torch")

from repro.runtime import faults as ref  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402

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
