"""The slice as a whole: IMM with the GreediRIS selector, then the
spread estimate, against ``repro`` on the same graph and key — seeds,
theta, coverage fraction and spread exactly equal (tolerance zero).
The reference runs its packed sampler, scan solver and scan receiver,
which its own contract makes bit-identical to its kernel paths."""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import diffusion as ref_diffusion  # noqa: E402
from repro.core import imm as ref_imm  # noqa: E402
from repro.launch import im_driver as ref_driver  # noqa: E402
from repro_torch.core import cascade, diffusion, imm  # noqa: E402
from repro_torch.launch import im_driver  # noqa: E402
from tests.test_torch_ref import graphs, partitionable, port_key  # noqa: E402,F401


@pytest.mark.parametrize("model,m,n,eps,max_theta", [
    ("IC", 1, 200, 0.13, 512), ("IC", 4, 200, 0.13, 512),
    ("LT", 4, 200, 0.13, 512),
    ("LT", 4, 120, 0.5, 1 << 15),   # two rounds, then the final top-up
])
def test_imm_greediris_then_spread(model, m, n, eps, max_theta):
    g_ref, g = graphs(n, 4.0, seed=0)
    jk = jax.random.key(0)
    want = ref_imm.imm(
        g_ref, 4, eps, jk, model=model, max_theta=max_theta,
        sampler="packed",
        selector=ref_imm.make_randgreedi_selector(m, "streaming", 0.077,
                                                  solver="scan"))
    got = imm.imm(
        g, 4, eps, port_key(jk), model=model, max_theta=max_theta,
        sampler="kernel",
        selector=imm.make_randgreedi_selector(m, "streaming", 0.077,
                                              use_kernel=True,
                                              solver="resident"))
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    assert (got.theta, got.rounds) == (want.theta, want.rounds)
    assert got.coverage_fraction == want.coverage_fraction
    assert got.lb == want.lb
    ek = jax.random.fold_in(jk, 99)
    s_ref = float(ref_diffusion.influence(g_ref, want.seeds, ek, model=model,
                                          num_sims=64, engine="packed"))
    assert float(diffusion.influence(g, torch.from_numpy(got.seeds),
                                     port_key(ek), model=model,
                                     num_sims=64)) == s_ref
    for engine, gather in (("packed", "auto"), ("kernel", "resident")):
        s = float(cascade.spread(g, torch.from_numpy(got.seeds),
                                 port_key(ek), model=model, num_sims=64,
                                 engine=engine, gather=gather))
        assert s == s_ref


def _im_lines(text):
    return [re.sub(r" in [0-9.]+s;", " in Xs;", ln)
            for ln in text.splitlines() if ln.startswith("[im]")]


@pytest.mark.parametrize("model", ["IC", "LT"])
def test_drivers_print_the_same_lines(model, capsys):
    flags = ["--n", "200", "--avg-deg", "4", "--k", "4", "--max-theta",
             "512", "--selector", "greediris", "--machines", "4",
             "--sampler", "packed", "--solver", "scan", "--eval-engine",
             "packed", "--eval-sims", "64", "--model", model]
    ref_driver.main(flags)
    want = _im_lines(capsys.readouterr().out)
    im_driver.main(flags + ["--device", "cpu"])
    got = _im_lines(capsys.readouterr().out)
    assert len(want) == 3 and got == want


def test_block_v_is_accepted_and_changes_nothing(capsys):
    """--block-v N|auto takes the reference's validation and leaves the
    [im] lines as they are without it; --block-v 0 exits 2, as the
    reference's parser does."""
    flags = ["--n", "120", "--avg-deg", "4", "--k", "3", "--max-theta",
             "256", "--machines", "2", "--eval-sims", "32", "--device",
             "cpu"]
    lines = []
    for extra in ([], ["--block-v", "128"], ["--block-v", "auto"]):
        im_driver.main(flags + extra)
        lines.append(_im_lines(capsys.readouterr().out))
    assert len(lines[0]) == 3 and lines[1] == lines[0] == lines[2]
    for parse in (ref_driver.main, im_driver.main):
        with pytest.raises(SystemExit) as exc:
            parse(flags[:-2] + ["--block-v", "0"])
        assert exc.value.code == 2


@pytest.mark.parametrize("flags", [
    ["--theta", "512", "--selector", "greediris", "--machines", "1"],
    ["--theta", "512", "--selector", "greediris-trunc", "--alpha", "0.5",
     "--aggregate", "pipeline", "--machines", "1"],
    ["--selector", "ripples", "--machines", "4"],
])
def test_drivers_print_the_same_round_lines(flags, capsys):
    """The fixed-theta round (one machine: the reference takes its
    device count, one here) and the Ripples selector print the
    reference's ``[im]`` lines."""
    common = ["--n", "200", "--avg-deg", "4", "--k", "4", "--max-theta",
              "512", "--sampler", "packed", "--solver", "scan",
              "--eval-engine", "packed", "--eval-sims", "64"]
    ref_driver.main(common + flags)
    want = _im_lines(capsys.readouterr().out)
    out = im_driver.run(common + flags + ["--device", "cpu"])
    got = _im_lines(capsys.readouterr().out)
    assert len(want) == 3 and got == want
    if "--theta" in flags:
        assert set(out["round"]["seconds"]) == {
            "sample_shuffle", "senders", "receiver", "merge"}
