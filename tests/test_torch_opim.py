"""Port parity: OPIM-C (``core.opim``) against the reference — the
certificate's floats exactly, and the loop's seeds, theta, rounds and
guarantee with the greedy and the GreediRIS selectors; the driver's
``--use-opim`` lines."""
import itertools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import imm as ref_imm  # noqa: E402
from repro.core import opim as ref  # noqa: E402
from repro.core import theory as ref_theory  # noqa: E402
from repro.launch import im_driver as ref_driver  # noqa: E402
from repro_torch.core import imm, opim, theory  # noqa: E402
from repro_torch.launch import im_driver  # noqa: E402
from tests.test_torch_ref import graphs, partitionable, port_key  # noqa: E402,F401

GRID = list(itertools.product(
    [0.0, 1.0, 37.0, 512.5], [0.0, 3.0, 40.0, 600.0], [32, 1024],
    [100, 262144], [1.0 / 128.0, 0.013], [1.0 - 1.0 / np.e, 0.123]))


@pytest.mark.parametrize("chunk", range(4))
def test_certify_equals_reference_floats(chunk):
    """Float64 host math: (sigma_lower, sigma_upper, guarantee) equal to
    the reference's, bit for bit, over a grid of coverages, thetas,
    sizes, deltas and alphas (zero coverage and the clamp included)."""
    for args in GRID[chunk::4]:
        assert opim.certify(*args) == ref.certify(*args)
        assert opim._sigma_lower(*args[1:5]) == ref._sigma_lower(*args[1:5])
        assert opim._sigma_upper(args[0], *args[2:5]) == \
            ref._sigma_upper(args[0], *args[2:5])


@pytest.mark.parametrize("selector", ["greedy", "greediris"])
@pytest.mark.parametrize("model", ["IC", "LT"])
def test_opim_matches_reference(selector, model):
    g_ref, g = graphs(100, 5.0, seed=5)
    jk = jax.random.key(5)
    if selector == "greedy":
        ref_sel, sel, alpha = (ref_imm.make_greedy_selector("scan"),
                               imm.make_greedy_selector("resident"), None)
    else:
        ref_sel = ref_imm.make_randgreedi_selector(4, "streaming",
                                                   alpha_trunc=0.5)
        sel = imm.make_randgreedi_selector(4, "streaming", alpha_trunc=0.5,
                                           use_kernel=True, solver="lazy")
        alpha = ref_theory.greediris_ratio(0.077, 0.0, 0.5)
        assert alpha == theory.greediris_ratio(0.077, 0.0, 0.5)
    want = ref.opim(g_ref, 4, 0.3, jk, model=model, theta0=128,
                    max_theta=1024, selector=ref_sel, solver_alpha=alpha,
                    sampler="packed")
    stats = {}
    got = opim.opim(g, 4, 0.3, port_key(jk), model=model, theta0=128,
                    max_theta=1024, selector=sel, solver_alpha=alpha,
                    sampler="kernel", stats=stats)
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    assert tuple(got[1:]) == tuple(want[1:])
    assert stats["bfs_steps"] > 0 and stats["select_s"] >= 0


def test_opim_default_selector_and_dense_sampler():
    g_ref, g = graphs(80, 4.0, seed=2)
    jk = jax.random.key(1)
    want = ref.opim(g_ref, 3, 0.2, jk, theta0=64, max_theta=512)
    got = opim.opim(g, 3, 0.2, port_key(jk), theta0=64, max_theta=512,
                    sampler="dense", solver="lazy")
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    assert tuple(got[1:]) == tuple(want[1:])


def test_driver_use_opim_prints_the_reference_lines(capsys):
    flags = ["--n", "150", "--avg-deg", "4", "--k", "4", "--max-theta",
             "512", "--selector", "greediris", "--machines", "2",
             "--sampler", "packed", "--solver", "scan", "--eval-engine",
             "packed", "--eval-sims", "32", "--use-opim"]
    ref_driver.main(flags)
    want = [re.sub(r" in [0-9.]+s;", " in Xs;", ln)
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[im]")]
    out = im_driver.run(flags + ["--device", "cpu"])
    got = [re.sub(r" in [0-9.]+s;", " in Xs;", ln)
           for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("[im]")]
    assert len(want) == 3 and "OPIM" in want[1] and got == want
    assert out["coverage_fraction"] is None and 0 <= out["guarantee"] <= 1
