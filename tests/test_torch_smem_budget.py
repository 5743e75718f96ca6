"""The shared-memory model of the port's kernels
(``repro_torch.kernels.smem_budget``, twin of the reference's
``kernels/vmem_budget.py``), on the CPU: the budget's resolution order,
the group planner, the compact layout's room and the receiver's chunk
as they were before they moved here, every full-size shape within the
H100's opt-in limit, and the receiver's chunking invisible in results.
The card tests (``tests/test_torch_cuda.py``) hold the model equal to
the C side."""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import streaming  # noqa: E402
from repro_torch.kernels import (bucket_insert, greedy_pick, ops,  # noqa: E402
                                 smem_budget)
from tests.test_torch_ref import (partitionable, to_port,  # noqa: E402,F401
                                  u32, words)


def test_budget_resolution_order(monkeypatch):
    """An override, else the CUDA device's opt-in limit, else (the CPU)
    the H100's 232,448 bytes."""
    assert smem_budget.HOPPER_OPTIN_BYTES == 232_448
    assert smem_budget.budget_bytes() == 232_448
    assert smem_budget.budget_bytes("cpu") == 232_448
    assert smem_budget.budget_bytes("cpu", override=1000) == 1000
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: types.SimpleNamespace(shared_memory_per_block_optin=99))
    assert smem_budget.budget_bytes("cuda") == 99
    assert smem_budget.budget_bytes("cuda:0", override=7) == 7
    assert smem_budget.stream_chunk_capacity(4, "cuda") == 0


# The arithmetic as it stood in kernels/greedy_pick.py, bucket_insert.py
# and csrc/bucket_insert.cu before it moved into smem_budget.
def _old_query_groups(b, num_words, budget):
    g = max(1, min(8, b, budget // (4 * num_words)))
    return g, -(-b // g)


def _old_list_room(m, n, w):
    cap = min(m, 16) * (m * n * w // 1024 + 1024)
    return min(cap, m * n * w)


def _old_stream_chunk_capacity(w, optin=232_448):
    avail = optin - 4 * 2 * 8 * 2 * 32 - 4 * ((w + 3) & ~3)
    return avail // (8 * w) if avail > 0 else 0


@pytest.mark.parametrize("b,w,budget", [
    (8, 4096, 229_000), (16, 4096, 229_000), (12, 36, 229_000),
    (13, 36, 229_000), (1, 4096, 229_000), (8, 20000, 229_000),
    (3, 70000, 229_000), (5, 4096, 0), (17, 36, 229_000), (9, 20000, 229_000),
])
def test_query_groups_as_before(b, w, budget):
    assert greedy_pick.query_groups is smem_budget.query_groups
    assert greedy_pick.query_groups(b, w, budget) == _old_query_groups(
        b, w, budget)


@pytest.mark.parametrize("m,n,w", [
    (1, 64, 4), (2, 301, 5), (8, 32768, 1024), (8, 32768, 4096),
    (8, 4096, 1024), (32, 1000, 7), (1, 1, 1), (16, 50000, 40)])
def test_list_room_as_before(m, n, w):
    assert greedy_pick.list_room is smem_budget.list_room
    assert greedy_pick.list_room(m, n, w) == _old_list_room(m, n, w)


@pytest.mark.parametrize("w", [1, 4, 11, 33, 1024, 4096, 20000, 60000])
def test_auto_chunk_size_as_before(w):
    """On the CPU the whole stream; the card's capacity is the C side's
    old formula at the H100's budget (held equal to the C side on the
    card)."""
    assert bucket_insert.auto_chunk_size is smem_budget.auto_chunk_size
    assert bucket_insert.auto_chunk_size(w, 23, "cpu") == 23
    assert bucket_insert.auto_chunk_size(w, 0, "cpu") == 1
    assert (smem_budget.stream_chunk_capacity(w)
            == _old_stream_chunk_capacity(w))


def test_query_budget_without_a_device_is_the_h100s():
    for lib, static in (("greedy_pick", 2112), ("lazy_greedy", 2208),
                        ("topk_gain", 2048)):
        assert smem_budget.query_budget(lib) == 232_448 - static
    # the serving batch's 8 queries of 4,096 words fit one group
    assert smem_budget.query_groups(
        8, 4096, smem_budget.query_budget("greedy_pick")) == (8, 1)


def test_every_launch_name_has_a_figure():
    assert set(smem_budget.FULL_SIZE) == set(ops.KERNELS)
    assert set(smem_budget.STATIC_BYTES) == set(ops.KERNELS)
    for kernel in ops.KERNELS:
        assert smem_budget.launch_bytes(kernel, 4096, 8) >= 0
    with pytest.raises(ValueError, match="unknown launch"):
        smem_budget.launch_bytes("nope", 1)


def test_figures_of_each_family():
    assert smem_budget.launch_bytes("greedy_pick", 1024) == 4096
    assert smem_budget.launch_bytes("lazy_greedy_batch", 4096, 8) == 131072
    # the receiver: 16-byte units, a cluster of two past 1,024 words
    assert smem_budget.launch_bytes("bucket_insert", 1024, 1) == 4096
    assert smem_budget.launch_bytes("bucket_insert_stream", 4096, 1) == 8192
    assert smem_budget.launch_bytes("bucket_insert", 11, 0) == 44
    assert smem_budget.launch_bytes("bucket_insert", 257, 0) == 4 * 129
    # the cascades stage their key table up to 48 KB, else read it
    assert smem_budget.launch_bytes("cascade_ic", 2, 128) == 512
    assert smem_budget.launch_bytes("cascade_ic", 2, 12288) == 49152
    assert smem_budget.launch_bytes("cascade_ic", 2, 12289) == 0
    assert smem_budget.launch_bytes("rrr_expand_ic", 1024) == 0


@pytest.mark.parametrize("kernel", sorted(smem_budget.FULL_SIZE))
def test_full_size_shapes_fit_the_h100(kernel):
    """Every launch at the full-size cells' shapes (PERF.md section 4)
    asks for no more shared memory, static and dynamic, than the
    H100's opt-in limit."""
    for cell, w, x in smem_budget.FULL_SIZE[kernel]:
        need = (smem_budget.launch_bytes(kernel, w, x)
                + smem_budget.STATIC_BYTES[kernel])
        assert need <= smem_budget.HOPPER_OPTIN_BYTES, (cell, need)


@pytest.mark.parametrize("w", [11, 4096])
def test_receiver_chunking_invisible_in_results(w):
    """The pipelined receiver's chunk (the model's capacity at the H100's
    budget, one candidate, the whole stream) never changes the state."""
    rng = np.random.default_rng(w)
    total = 29
    rows = to_port(words(rng, (total, w), density=0.05))
    ids = torch.from_numpy(rng.integers(-1, 40, total).astype(np.int32))
    cap = smem_budget.stream_chunk_capacity(w)
    assert cap >= 1
    outs = []
    for chunk in sorted({1, min(cap, total), total}):
        st = streaming.init_state(5, 0.2, 30.0, w, device="cpu")
        c_ids, c_rows = streaming.chunk_stream(ids, rows, chunk)
        outs.append(streaming.insert_stream(st, c_ids, c_rows, 5,
                                            use_kernel=False))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(u32(a), u32(b))
