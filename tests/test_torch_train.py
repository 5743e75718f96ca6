"""The port's train steps and launcher (``repro_torch.train.steps``,
``repro_torch.launch.train``) against the reference's: one train step's
loss, gradient norm, learning rate and first moments on the fp32
variants (rtol 1e-4; the parameters after a step are not held, since the
first AdamW step moves each by about ``lr * sign(g)`` and a gradient
entry near zero may take either sign), microbatched accumulation
against the reference's and against the full batch, and the launcher on
the CPU: a few steps with ``--coreset --ckpt``, a resume that restores
the saved state bit for bit, and two steps of each MoE, MLA, RG-LRU and
encoder-decoder architecture (the encoder-decoder with ``--coreset``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as ref_model  # noqa: E402
from repro.optim.adamw import OptConfig as RefOptConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

F32_TOL = dict(rtol=1e-4, atol=1e-5)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


def _states(arch, f32=True, b=4, s=16):
    rc, cfg = lm_ref.configs(arch, f32)
    npp = lm_ref.ref_params(rc, 0)
    nb = lm_ref.batch(rc, 0, b=b, s=s)
    rb = ref_model.build(rc, RefOptConfig(**OPT), sharded=False)
    pb = model.build(cfg, adamw.OptConfig(**OPT), sharded=False,
                     device="cpu")
    jp = lm_ref.to_jax(npp)
    tp = convert.params_from_reference(npp, cfg, device="cpu")
    rstate = ref_model.steps_lib.TrainState(
        jp, ref_model.adamw.init(jp, rb.opt_cfg))
    pstate = steps.TrainState(tp, adamw.init(tp, pb.opt_cfg))
    return (rb, rstate, lm_ref.to_jax(nb), pb, pstate,
            convert.batch_from_reference(nb, device="cpu"))


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2.5-14b",
                                  "llava-next-mistral-7b", "mamba2-370m",
                                  "deepseek-v3-671b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(arch, micro):
    rb, rs, jb, pb, ps, tb = _states(arch)
    rs2, rm = jax.jit(rb.train_step(microbatches=micro))(rs, jb)
    ps2, pm = pb.train_step(microbatches=micro)(ps, tb)
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[name]), float(rm[name]),
                                   **F32_TOL, err_msg=name)
    assert int(ps2.opt.step) == int(rs2.opt.step) == 1
    # m = (1 - b1) * clipped g: the gradients, scaled
    for (k, a), (_, b) in zip(lm_ref.leaves(rs2.opt.m),
                              lm_ref.leaves(ps2.opt.m)):
        np.testing.assert_allclose(lm_ref.f32(b), lm_ref.f32(a), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_microbatch_grads_equal_full_batch_in_fp32():
    """Two microbatches' gradients, summed in fp32 and averaged, equal
    the full batch's (the loss is a mean over equal halves)."""
    _, _, _, pb, ps, tb = _states("gemma-7b")
    loss, _, full = steps.loss_and_grads(ps.params, pb.cfg, {}, tb)
    halves = [steps.loss_and_grads(
        ps.params, pb.cfg, {}, {k: v[i * 2:(i + 1) * 2] for k, v in
                                tb.items()}) for i in range(2)]
    np.testing.assert_allclose(float((halves[0][0] + halves[1][0]) / 2),
                               float(loss), **F32_TOL)
    for (k, g), (_, a), (_, b) in zip(lm_ref.leaves(full),
                                      lm_ref.leaves(halves[0][2]),
                                      lm_ref.leaves(halves[1][2])):
        np.testing.assert_allclose(lm_ref.f32((a + b) / 2), lm_ref.f32(g),
                                   **F32_TOL, err_msg=k)


def test_microbatch_equals_full_batch_grads():
    """Gradient accumulation over 2 microbatches == single batch (twin
    of the reference's test, on the bf16 SMOKE)."""
    cfg = get_config("gemma-7b", smoke=True)
    bundle = model.build(cfg, adamw.OptConfig(**OPT), sharded=False,
                         device="cpu")
    state, _ = bundle.init_state(0)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 17),
                                     generator=gen, dtype=torch.int32)}
    s1, m1 = bundle.train_step(microbatches=1)(state, batch)
    s2, m2 = bundle.train_step(microbatches=2)(state, batch)
    a = tree_leaves(s1.params)[0].float().numpy()
    b = tree_leaves(s2.params)[0].float().numpy()
    np.testing.assert_allclose(a, b, rtol=0.05, atol=1e-3)
    assert not torch.equal(tree_leaves(s1.params)[0],
                           tree_leaves(state.params)[0])


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_launcher_coreset_checkpoint_and_bit_exact_resume(tmp_path, capsys):
    args = ["--arch", "gemma-7b", "--smoke", "--batch", "4", "--seq", "16",
            "--coreset", "--ckpt", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu"]
    first = {}
    assert train.main(args + ["--steps", "4"], report=first) == 0
    assert first["final_step"] == 4 and first["restored_step"] == -1
    assert len(first["losses"]) == 4 and np.isfinite(first["losses"]).all()
    second = {}
    assert train.main(args + ["--steps", "6"], report=second) == 0
    out = capsys.readouterr().out
    assert "[train] restored checkpoint at step 4" in out
    assert second["restored_step"] == 4 and second["final_step"] == 6
    assert len(second["losses"]) == 2
    _same_tree(second["restored"], first["state"])
    assert int(second["restored"].opt.step) == 4
    assert "[train] done at step 6" in out


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "mamba2-370m"])
def test_launcher_runs_vlm_and_ssm(arch, capsys):
    report = {}
    assert train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                       "2", "--seq", "16", "--microbatches", "2",
                       "--device", "cpu"], report=report) == 0
    assert report["final_step"] == 2 and np.isfinite(report["losses"]).all()
    assert "[train] timing: median step" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_launcher_runs_moe_mla_rglru_and_encdec(arch, capsys):
    """Two launcher steps of each architecture the LM scaffold's part 2
    brought: finite losses, parameters that move; the encoder-decoder's
    batches carry frames, and it picks them through ``--coreset``."""
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu"]
    if arch == "seamless-m4t-large-v2":
        argv.append("--coreset")
    report = {}
    assert train.main(argv, report=report) == 0
    assert report["final_step"] == 2 and len(report["losses"]) == 2
    assert np.isfinite(report["losses"]).all()
    cfg = get_config(arch, smoke=True)
    fresh, _ = model.build(cfg, sharded=False, device="cpu").init_state(0)
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(fresh.params), tree_leaves(report["state"].params))]
    assert all(moved), f"{moved.count(False)} leaves did not move"
    assert "[train] done at step 2" in capsys.readouterr().out


def test_launcher_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--arch", "gemma-7b", "--smoke", "--steps", "1"])
