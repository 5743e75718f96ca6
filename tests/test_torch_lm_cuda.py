"""The LM scaffold on the card against the CPU (bf16, rtol 0.05, atol
0.05): each SMOKE's logits, loss (with the MoE aux and MTP losses) and
gradients, and prefill plus decode against the forward; card-resident
restores of a train state, one with an unstacked MTP layer among them.
Needs an NVIDIA GPU; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from tools import time_lm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_smoke_archs_on_card_match_cpu(dev):
    errs = time_lm.smoke_parity(dev)
    assert set(errs) == set(time_lm.PORTED)


def test_moe_mla_rglru_encdec_smokes_on_card_match_cpu(dev):
    errs = time_lm.part2_parity(dev)
    assert set(errs) == set(time_lm.MOE_MLA_RGLRU_ENCDEC)
    assert {"aux_loss", "mtp_loss"} <= set(errs["deepseek-v3-671b"])


def test_card_restore_keeps_a_train_state_on_the_card(dev, tmp_path):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves
    bundle = model.build(get_config("mamba2-370m", smoke=True),
                         sharded=False, device=dev)
    state, _ = bundle.init_state(0)
    store = CheckpointStore(str(tmp_path))
    store.save(1, state, blocking=True)
    back, step = store.restore(state)
    assert step == 1
    for a, b in zip(tree_leaves(state),
                    tree_leaves(back)):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b)


def test_card_restore_keeps_an_mtp_state_unstacked(dev, tmp_path):
    """deepseek's SMOKE state (its MTP layer unstacked) saved and
    restored on the card: the same leaves, shapes and bits, ``ln1`` of
    the MTP layer still [d_model]."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves
    cfg = get_config("deepseek-v3-671b", smoke=True)
    state, _ = model.build(cfg, sharded=False, device=dev).init_state(0)
    store = CheckpointStore(str(tmp_path))
    store.save(1, state, blocking=True)
    back, step = store.restore(state)
    assert step == 1
    assert tuple(back.params["mtp"]["layer"]["ln1"].shape) == (cfg.d_model,)
    assert tuple(back.opt.m["mtp"]["layer"]["ln1"].shape) == (cfg.d_model,)
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert b.device == a.device and b.dtype == a.dtype
        assert b.shape == a.shape and torch.equal(a, b)
