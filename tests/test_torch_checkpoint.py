"""The port's checkpoint store (``checkpoint.store``): round trips of
torch and numpy trees, the CRC check, GC of all but the newest steps,
the ``checkpoint.write`` fault site, and a writer that never reads the
caller's memory after ``save`` returns."""
import os
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "w": torch.tensor([-1, 2**31 - 1], dtype=torch.int32)},
            "key": np.asarray([7, 2**32 - 1], np.uint32),
            "pair": {"n": np.int64(3), "e": torch.zeros(0, dtype=torch.int64)}}


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


def test_round_trip_keeps_structure_types_and_bits(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(10, _tree(), blocking=True)
    back, step = store.restore(_tree())
    assert step == 10
    _same(_tree(), back)
    # leaves are written in the reference's order: sorted dict keys
    d = os.path.join(str(tmp_path), "step_000000010")
    assert np.load(os.path.join(d, "leaf_00001.npy")).dtype == np.int16
    assert np.load(os.path.join(d, "leaf_00003.npy")).dtype == np.uint32


def test_gc_keeps_the_newest_and_resave_replaces(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, {"x": torch.tensor(s)}, blocking=True)
    assert store.list_steps() == [3, 4]
    store.save(3, {"x": torch.tensor(31)}, blocking=True)
    store.save(5, {"x": torch.tensor(5)}, blocking=True)
    assert store.list_steps() == [4, 5]
    back, step = store.restore({"x": torch.tensor(0)}, step=4)
    assert step == 4 and int(back["x"]) == 4
    assert store.restore({"x": 0})[1] == 5


def test_crc_catches_corruption(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(5, _tree(), blocking=True)
    fn = os.path.join(str(tmp_path), "step_000000005", "leaf_00000.npy")
    with open(fn, "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\x01")
    with pytest.raises(IOError, match="CRC mismatch"):
        store.restore(_tree())


def test_template_mismatch_and_empty_store(tmp_path):
    store = CheckpointStore(str(tmp_path))
    assert store.restore(_tree()) == (None, -1)
    store.save(1, _tree(), blocking=True)
    with pytest.raises(ValueError, match="structure mismatch"):
        store.restore({"a": 0})


def test_write_fault_surfaces_on_blocking_save(tmp_path):
    plan = faults.FaultPlan(
        [faults.FaultSpec("checkpoint.write", "write_fail", at=0),
         faults.FaultSpec("checkpoint.write", "raise", at=1)])
    store = CheckpointStore(str(tmp_path), fault_plan=plan)
    for _ in range(2):
        with pytest.raises(faults.InjectedFault):
            store.save(7, {"x": torch.tensor(1)}, blocking=True)
        assert store.list_steps() == []          # nothing partial published
        assert isinstance(store.clear_error(), faults.InjectedFault)
    store.save(7, {"x": torch.tensor(1)}, blocking=True)
    assert store.list_steps() == [7]
    assert [e["step"] for e in plan.events] == [7, 7]


def test_a_non_blocking_save_copies_before_it_returns(tmp_path):
    """The writer works on host copies taken inside ``save``: the
    caller may overwrite its tensor right after."""
    store = CheckpointStore(str(tmp_path))
    x = torch.arange(1000, dtype=torch.int32)
    store.save(1, {"x": x})
    x.fill_(-1)
    store.wait()
    back, _ = store.restore({"x": x})
    assert torch.equal(back["x"], torch.arange(1000, dtype=torch.int32))


# ---- restore device: each tensor leaf on its template leaf's device ----

class _Opt(NamedTuple):
    m: dict
    step: torch.Tensor


class _State(NamedTuple):
    params: dict
    opt: _Opt


def _state(dev="cpu"):
    p = {"w": torch.arange(6, dtype=torch.bfloat16, device=dev).reshape(2, 3),
         "b": torch.ones(3, device=dev)}
    return _State(p, _Opt({k: v.float() * 0.5 for k, v in p.items()},
                          torch.tensor(4, dtype=torch.int32, device=dev)))


def test_cpu_template_restores_to_the_cpu(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(3, {"x": torch.arange(4)}, blocking=True)
    back, step = store.restore({"x": torch.zeros(4, dtype=torch.int64)})
    assert step == 3 and back["x"].device.type == "cpu"
    assert torch.equal(back["x"], torch.arange(4))


def test_named_tuple_state_round_trips_in_jax_tree_order(tmp_path):
    """A train state of NamedTuples keeps its types and bits, its leaves
    stored as ``jax.tree`` orders them (dict keys sorted, fields in
    order)."""
    store = CheckpointStore(str(tmp_path))
    store.save(4, _state(), blocking=True)
    back, step = store.restore(_state())
    assert step == 4 and isinstance(back, _State)
    assert isinstance(back.opt, _Opt)
    for a, b in zip((back.params["b"], back.params["w"], back.opt.m["b"],
                     back.opt.m["w"], back.opt.step),
                    (_state().params["b"], _state().params["w"],
                     _state().opt.m["b"], _state().opt.m["w"],
                     _state().opt.step)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    d = os.path.join(str(tmp_path), "step_000000004")
    assert np.load(os.path.join(d, "leaf_00001.npy")).dtype == np.int16
    assert np.load(os.path.join(d, "leaf_00004.npy")).dtype == np.int32


@pytest.mark.cuda
def test_card_template_restores_to_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = CheckpointStore(str(tmp_path))
    store.save(2, _state("cuda"), blocking=True)
    back, _ = store.restore(_state("cuda"))
    assert back.params["w"].device.type == "cuda"
    assert back.opt.step.device.type == "cuda"
    assert torch.equal(back.params["w"].cpu(), _state().params["w"])
    host, _ = store.restore(_state("cuda"), device="cpu")   # explicit wins
    assert host.params["w"].device.type == "cpu"


@pytest.mark.cuda
def test_supervisor_resumes_with_card_tensors(tmp_path):
    """A rollback on the card hands the step function card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.runtime.fault_tolerance import (RunSupervisor,
                                                     SupervisorConfig)
    store = CheckpointStore(str(tmp_path))
    sup = RunSupervisor(store, SupervisorConfig(checkpoint_every=1),
                        sleep_fn=lambda s: None)
    seen, failed = [], []

    def step_fn(state, batch):
        seen.append(state["x"].device.type)
        if batch == 2 and not failed:
            failed.append(batch)
            raise RuntimeError("flake")
        return {"x": state["x"] + 1}, {"loss": 0.0}

    state, step = sup.run({"x": torch.zeros(2, device="cuda")}, step_fn,
                          lambda s: s, 4)
    assert step == 4 and failed == [2]
    assert set(seen) == {"cuda"} and state["x"].device.type == "cuda"
