"""The port's checkpoint store (``checkpoint.store``): round trips of
torch and numpy trees, the CRC check, GC of all but the newest steps,
the ``checkpoint.write`` fault site, and a writer that never reads the
caller's memory after ``save`` returns."""
import os

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
