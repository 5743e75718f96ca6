"""The port's config registry (``repro_torch.configs``) against the
reference's: every field of all ten CONFIGs and SMOKEs, the parameter
counts, the layer specs and stack plans (exact, pure Python), the shape
cells, and the port's init against the reference's leaf shapes for all
ten SMOKEs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

CASES = [(a, s) for a in configs.ARCHS for s in (False, True)]


def test_registry_lists_the_same_ten_archs():
    assert configs.ARCHS == ref_configs.ARCHS and len(configs.ARCHS) == 10
    assert set(lm_ref.PORTED) == set(configs.ARCHS)


@pytest.mark.parametrize("arch,smoke", CASES)
def test_config_fields_equal(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = ref_configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pattern() == want.pattern()
    assert got.pdtype == getattr(torch, want.param_dtype)
    assert got.cdtype == getattr(torch, want.compute_dtype)


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_counts_exact(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = ref_configs.get_config(arch, smoke=smoke)
    assert configs.param_count(got) == ref_configs.param_count(want)
    assert (configs.active_param_count(got)
            == ref_configs.active_param_count(want))


@pytest.mark.parametrize("arch,smoke", CASES)
def test_layer_specs_and_plan_exact(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = ref_configs.get_config(arch, smoke=smoke)
    assert transformer.layer_specs(got) == ref_tfm.layer_specs(want)
    assert transformer.build_plan(got) == ref_tfm.build_plan(want)


def test_plan_override_and_remainder():
    unit = (("attn", "dense", 0), ("ssd", "none", 0))
    cfg = common.ModelConfig(plan_override=((unit, 3),))
    ref = ref_tfm.ModelConfig(plan_override=((unit, 3),))
    assert transformer.build_plan(cfg) == ref_tfm.build_plan(ref)
    pat = ("ssd", "ssd", "attn") * 2 + ("ssd",)
    cfg = common.ModelConfig(num_layers=7, block_pattern=pat)
    ref = ref_tfm.ModelConfig(num_layers=7, block_pattern=pat)
    assert transformer.build_plan(cfg) == ref_tfm.build_plan(ref)


def test_shape_cells():
    assert configs.SHAPES == {k: configs.ShapeCell(**dataclasses.asdict(v))
                              for k, v in ref_configs.SHAPES.items()}
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        assert configs.cells_for(cfg) == ref_configs.cells_for(
            ref_configs.get_config(arch))


@pytest.mark.parametrize("arch", lm_ref.PORTED)
def test_init_leaf_shapes_match_reference(arch):
    ref_cfg, cfg = lm_ref.configs(arch)
    want, want_specs = lm_ref.ref_init(ref_cfg)(jax.random.key(0), ref_cfg)
    got, got_specs = lm_ref.port_init(cfg)(common.generator(0, "cpu"), cfg)
    w, g = lm_ref.leaves(want), lm_ref.leaves(got)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(w, g):
        assert tuple(b.shape) == a.shape, k
        assert b.numel() == a.size, k
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), k
    assert got_specs == want_specs
