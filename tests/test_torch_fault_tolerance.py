"""Port parity: the fault-tolerance runtime (``runtime.fault_tolerance``)
against ``repro.runtime.fault_tolerance`` — the run supervisor over each
package's checkpoint store restarts, backs off, skips poisoned steps and
clears failure counts exactly as the reference's does; the straggler
monitor flags and shrinks alpha the same; ``usable_machines`` is the
reference's function; ``elastic_remesh`` raises without a device."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointStore as RefStore  # noqa: E402
from repro.runtime import fault_tolerance as ref  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402

SIDES = ((ft, CheckpointStore, torch.tensor), (ref, RefStore, jnp.asarray))


def _supervise(tmp_path, cfg_kw, make_step, num_steps, **sup_kw):
    """Run the supervisor of each package on its own store; return what
    each saw: (final step, restarts, failures_at, sleeps, the set of
    steps run, monitor mean set).  Saves are written in the background
    and a restart restores the newest step already published, so which
    steps are replayed (and the state they restart from) depends on the
    writer thread's timing in both packages: it is not compared."""
    out = []
    for mod, store_cls, arr in SIDES:
        # keep every step: a restore never races the writer's deletes
        store = store_cls(str(tmp_path / mod.__name__), keep=1000)
        sleeps, seen = [], []
        ticks = iter(range(1000))
        mon = mod.StragglerMonitor()
        sup = mod.RunSupervisor(store, mod.SupervisorConfig(**cfg_kw),
                                sleep_fn=sleeps.append,
                                clock=lambda it=ticks: float(next(it)),
                                monitor=mon, **sup_kw)
        state, final = sup.run({"x": arr(0)}, make_step(seen), lambda s: s,
                               num_steps=num_steps)
        out.append((final, sup.restarts, dict(sup.failures_at), sleeps,
                    sorted(set(seen)), mon.mean is not None))
    return out


def test_supervisor_recovers_from_failures(tmp_path):
    def make_step(seen):
        fail_once = {"done": False}

        def step_fn(state, batch):
            if batch == 5 and not fail_once["done"]:
                fail_once["done"] = True
                raise RuntimeError("injected chip failure")
            seen.append(batch)
            return {"x": state["x"] + 1}, {"loss": 1.0}
        return step_fn
    got, want = _supervise(tmp_path, dict(checkpoint_every=2, backoff_s=0.01,
                                          max_restarts=10), make_step, 8)
    assert got == want
    assert got[0] == 8 and got[1] == 1 and got[3] == [0.01]


def test_supervisor_skips_poison_step(tmp_path):
    def make_step(seen):
        def step_fn(state, batch):
            seen.append(batch)
            return state, {"loss": float("nan") if batch == 3 else 1.0}
        return step_fn
    got, want = _supervise(tmp_path, dict(checkpoint_every=100,
                                          backoff_s=0.01, poison_threshold=2,
                                          max_restarts=10), make_step, 6)
    assert got == want
    assert got[0] == 6 and got[2] == {3: 2}


def test_supervisor_injectable_clock_and_sleep(tmp_path):
    """Backoff goes through sleep_fn (recorded, never slept) and step
    times through the clock into the monitor."""
    def make_step(seen):
        boom = {"armed": True}

        def step_fn(state, batch):
            if batch == 2 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("flake")
            seen.append(batch)
            return state, {"loss": 1.0}
        return step_fn
    got, want = _supervise(tmp_path, dict(checkpoint_every=100, backoff_s=2.0,
                                          max_restarts=10), make_step, 4)
    assert got == want
    assert got[0] == 4 and got[3] == [2.0] and got[5]


def test_supervisor_resets_failure_counter_on_success(tmp_path):
    def make_step(seen):
        fails = {3: 1, 5: 1}

        def step_fn(state, batch):
            if fails.get(batch, 0) > 0:
                fails[batch] -= 1
                raise RuntimeError(f"flake at {batch}")
            seen.append(batch)
            return state, {"loss": 1.0}
        return step_fn
    got, want = _supervise(tmp_path, dict(checkpoint_every=1, backoff_s=0.0,
                                          poison_threshold=2,
                                          max_restarts=10), make_step, 7)
    assert got == want
    assert got[0] == 7 and got[2] == {} and got[4] == list(range(7))


def test_supervisor_gives_up_past_max_restarts(tmp_path):
    for mod, store_cls, arr in SIDES:
        sup = mod.RunSupervisor(store_cls(str(tmp_path / mod.__name__)),
                                mod.SupervisorConfig(max_restarts=2),
                                sleep_fn=lambda s: None)

        def step_fn(state, batch):
            raise RuntimeError("always")
        with pytest.raises(RuntimeError, match="always"):
            sup.run({"x": arr(0)}, step_fn, lambda s: s, num_steps=3)
        assert sup.restarts == 3


@pytest.mark.parametrize("requested,available", [
    (6, 8), (8, 5), (3, 8), (1, 1), (16, 16), (4, 0), (0, 8), (-1, 0)])
def test_usable_machines_matches_reference(requested, available):
    def outcome(fn):
        try:
            return fn(requested, available)
        except (ValueError, RuntimeError) as e:
            return type(e).__name__
    assert outcome(ft.usable_machines) == outcome(ref.usable_machines)
    if available < 1 <= requested:
        with pytest.raises(RuntimeError, match="no devices available"):
            ft.usable_machines(requested, available)


def test_elastic_remesh_on_one_device(monkeypatch):
    """The machines are a batch axis of one device: any request rounds
    down to a power of two; CUDA without a card raises."""
    assert [ft.elastic_remesh(m, "cpu") for m in (1, 3, 6, 8, 13)] == \
        [1, 2, 4, 8, 8]
    with pytest.raises(ValueError, match=">= 1"):
        ft.elastic_remesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no devices available"):
        ft.elastic_remesh(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ft.elastic_remesh(6, "cuda") == 4


@pytest.mark.parametrize("alpha,times", [
    (0.3, [1.0] * 20 + [10.0]),
    (0.1, [1.0, 1.0, 1.0, 1e3, 1e6, 1e9]),
    (0.5, [2.0, 2.1, 1.9, 2.0, 9.0, 2.0, 9.5, 30.0]),
])
def test_straggler_monitor_matches_reference(alpha, times):
    mine, theirs = ft.StragglerMonitor(alpha=alpha), \
        ref.StragglerMonitor(alpha=alpha)
    assert [mine.observe(t) for t in times] == \
        [theirs.observe(t) for t in times]
    assert (mine.mean, mine.var, mine.flags) == \
        (theirs.mean, theirs.var, theirs.flags)
    for a in (0.125, 1.0, 1.0 / 64):
        assert mine.suggest_alpha(a) == theirs.suggest_alpha(a)


def test_straggler_monitor_flags_outlier():
    mon = ft.StragglerMonitor(alpha=0.3)
    for _ in range(20):
        assert not mon.observe(1.0)
    assert mon.observe(10.0)
    assert mon.suggest_alpha(0.125) == 0.125  # needs >= 3 flags
    mon.flags = 3
    assert mon.suggest_alpha(0.125) == 0.0625
    assert mon.suggest_alpha(1.0 / 64) == 1.0 / 64
