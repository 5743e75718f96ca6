"""The port's launch and footprint checker (``repro_torch.analysis``), on
the CPU.

Pinned here:
  * every violation fixture below is caught by EXACTLY its rule (the
    counterpart of ``tests/test_analysis.py`` without the Pallas-only
    rules: ``launch-context``, ``interpret-flag``, ``aliasing``,
    ``launch-grid``, the HLO pass, and the four Pallas lint rules);
  * the real registry passes clean on the CPU (the plain versions: no
    launch), covers its families, reaches every launch name of
    ``ops.KERNELS`` and holds every contract name of the reference;
  * each contract the reference has runs to the same bits in both
    packages (the reference's Pallas kernels in interpret mode);
  * the recorder and the launch hook, the repo-wide lint, and the CLI.
"""
import inspect
import json
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REPO  # noqa: E402
from repro_torch.analysis import (ast_rules, check, contracts,  # noqa: E402
                                  trace_check)
from repro_torch.analysis.contracts import (Fixture,  # noqa: E402
                                            KernelContract, ShapePattern)
from repro_torch.kernels import build, coverage, ops  # noqa: E402
from tests.test_torch_ref import partitionable, u32  # noqa: E402,F401

CPU = torch.device("cpu")


def _fixture_contract(fn, **overrides):
    shapes = overrides.pop("shapes", {})
    steps = overrides.pop("steps", None)
    defaults = dict(
        name="fixture", family="fixture", description="",
        build=lambda device: Fixture(fn=fn, shapes=shapes, steps=steps),
        launches={})
    defaults.update(overrides)
    return KernelContract(**defaults)


def _rules(contract):
    report = contracts.run_contract(contract, CPU)
    return [v.rule for v in report.violations]


def _identity():
    return torch.arange(8, dtype=torch.int32) + 1


# ------------------------------------------------ contract-rule corpus
def test_extra_launch_caught_by_launch_count_only():
    """A launch the contract does not declare (noted as ``ops.launch``
    notes one) fails the launch count alone."""
    def double_launch():
        ops.RECORDER.note_launch("bucket_gains")
        return _identity()
    assert _rules(_fixture_contract(double_launch)) == ["launch-count"]


def test_per_step_count_over_no_step_caught_by_launch_count_only():
    c = _fixture_contract(_identity, launches={"coverage": 1},
                          per_step=True, steps=lambda: 0,
                          shapes={"coverage": (4, 0)})
    assert _rules(c) == ["launch-count"]


def test_f64_leak_caught_by_dtype_whitelist_only():
    def f64_leak():
        return _identity().to(torch.float64).sum()
    c = _fixture_contract(f64_leak,
                          dtype_whitelist=frozenset({"int32", "int64"}))
    report = contracts.run_contract(c, CPU)
    (violation,) = report.violations
    assert violation.rule == "dtype-whitelist"
    assert "float64" in violation.message


def test_mask_shaped_intermediate_caught_by_forbidden_rule_only():
    def gmask_intermediate():
        return torch.zeros((4, 7, 2), dtype=torch.int32).sum()
    c = _fixture_contract(gmask_intermediate,
                          forbidden=(ShapePattern("int32", (4, 7, 2),
                                                  "gmask"),))
    assert _rules(c) == ["forbidden-intermediate"]


def test_a_view_counts_as_built():
    """The streamed sampler's mask is a view of its gather: a view of
    the pattern's shape is a tensor the call built."""
    def viewed():
        return torch.zeros((56,), dtype=torch.int32).view(4, 7, 2)
    c = _fixture_contract(viewed, required=(ShapePattern("int32",
                                                         (4, 7, 2)),))
    assert _rules(c) == []


def test_required_intermediate_missing_caught():
    """The forbidden pattern's twin: a contract requiring a shape the call
    never builds (keeps forbidden checks non-vacuous)."""
    c = _fixture_contract(_identity,
                          required=(ShapePattern("int32", (4, 7, 2)),))
    assert _rules(c) == ["missing-intermediate"]


@pytest.mark.parametrize("w,budget", [(4096, 1024), (60_000, None)])
def test_smem_budget_overflow_caught_by_footprint_only(w, budget):
    """A cover wider than the budget (a 1 KiB budget, or the H100's
    232,448 bytes against a 240,000-byte cover) fails the footprint."""
    c = _fixture_contract(_identity, launches={"greedy_pick": 1},
                          shapes={"greedy_pick": (w, 0)},
                          max_smem_bytes=budget)
    assert _rules(c) == ["smem-footprint"]


def test_undeclared_launch_shape_caught_by_footprint_only():
    c = _fixture_contract(_identity, launches={"coverage": 1})
    assert _rules(c) == ["smem-footprint"]


def test_clean_fixture_passes():
    c = _fixture_contract(_identity, launches={"coverage": 1},
                          shapes={"coverage": (4096, 0)},
                          dtype_whitelist=frozenset({"int32"}))
    report = contracts.run_contract(c, CPU)
    assert report.ok, report.violations
    assert report.stats["launches"] == {}
    assert report.stats["smem"] == {"coverage": {"dynamic": 16384,
                                                 "static": 0}}


# --------------------------------------------------- recorder and hook
def test_launch_hook_is_a_noop_without_a_recorder():
    assert ops.RECORDER is None
    with trace_check.Recorder() as outer:
        assert ops.RECORDER is outer
        with trace_check.Recorder() as inner:
            assert ops.RECORDER is inner
            ops.RECORDER.note_launch("coverage")
        assert ops.RECORDER is outer
    assert ops.RECORDER is None
    assert trace_check.launch_counts(inner) == {"coverage": 1}
    assert trace_check.launch_sites(outer) == []


def test_recorder_sees_ops_dtypes_and_shapes():
    out, rec = trace_check.record(
        lambda: torch.ones((3, 5), dtype=torch.bool).sum(1))
    assert tuple(out.shape) == (3,)
    assert trace_check.has_intermediate(rec, "bool", (3, 5))
    assert trace_check.has_intermediate(rec, "int64", (3,))
    assert trace_check.dtypes_used(rec) == {"bool", "int64"}


def test_recorder_rejects_anything_but_a_recording():
    _, rec = trace_check.record(_identity)
    with pytest.raises(TypeError, match="never a printed trace"):
        trace_check.launch_sites(str(rec.ops))


# --------------------------------------------------------- AST corpus
def bad_jax_import():
    import jax.numpy  # noqa: F401


def bad_reference_import():
    from repro.core import rrr  # noqa: F401


def bad_kernel_fallback(rows, covered):
    try:
        return coverage.marginal_gain(rows, covered)
    except RuntimeError:
        return coverage.marginal_gain_plain(rows, covered)


def bad_kernel_fallback_pass(rows, covered):
    gains = None
    try:
        gains = coverage.marginal_gain(rows, covered)
    except ValueError:
        pass
    return gains


def bad_cpu_fallback(x):
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return x.to(dev)


def bad_cpu_fallback_branch(x):
    if not torch.cuda.is_available():
        return x.cpu()
    return x


def bad_launch_outside_ops(rows):
    f = build.function("coverage", "coverage", [ops.PTR])
    return f(rows.data_ptr())


def clean_port_code(rows, covered, w, device):
    if not torch.cuda.is_available():
        raise RuntimeError("needs a card")
    try:
        gains = coverage.marginal_gain(rows, covered)
    except ValueError as e:
        raise RuntimeError("refused") from e
    cap = build.function("bucket_insert", "stream_chunk_capacity",
                         [ops.I64])(w)
    budget = build.function("lazy_greedy", f"{device}_batch_budget", [])()
    return gains, cap, budget


def _lint_fn(fn):
    src = textwrap.dedent(inspect.getsource(fn))
    return [v.rule for v in ast_rules.lint_source(src, "fixture.py")]


@pytest.mark.parametrize("fn,rule", [
    (bad_jax_import, "jax-import"),
    (bad_reference_import, "jax-import"),
    (bad_kernel_fallback, "kernel-fallback"),
    (bad_kernel_fallback_pass, "kernel-fallback"),
    (bad_cpu_fallback, "cpu-fallback"),
    (bad_cpu_fallback_branch, "cpu-fallback"),
    (bad_launch_outside_ops, "launch-outside-ops"),
])
def test_bad_fixture_caught_by_its_rule_only(fn, rule):
    assert _lint_fn(fn) == [rule]


def test_clean_port_code_passes_lint():
    assert _lint_fn(clean_port_code) == []
    assert _lint_fn(_identity) == []


def test_launch_outside_ops_allowed_in_ops_only():
    src = textwrap.dedent(inspect.getsource(bad_launch_outside_ops))
    assert ast_rules.lint_source(src, "src/repro_torch/kernels/ops.py") == []


def test_repo_wide_ast_lint_clean():
    assert ast_rules.lint_paths(repo_root=REPO) == []


# ------------------------------------------------------- real registry
def test_registry_clean_pass_and_family_coverage():
    reports = [contracts.run_contract(c, CPU)
               for c in contracts.build_registry()]
    failures = [(r.name, r.violations) for r in reports if not r.ok]
    assert not failures, failures
    assert {r.family for r in reports} == set(contracts.FAMILIES)
    assert all(r.stats["launches"] == {} for r in reports)
    assert all(r.stats["steps"] for r in reports
               if contracts.contracts_by_name()[r.name].per_step)


def test_registry_reaches_every_launch_name_and_the_reference_names():
    """Declarations only: no fixture is built or run."""
    from repro.analysis import contracts as reference
    registry = contracts.build_registry()
    reached = {k for c in registry for k, n in c.launches.items() if n}
    assert reached == set(ops.KERNELS)
    names = {c.name for c in registry}
    assert len(names) == len(registry)
    assert set(reference.contracts_by_name()) <= names


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _leaves(y)]
    return [np.asarray(x.numpy() if hasattr(x, "numpy") else x)]


@pytest.mark.parametrize("name", [
    "rrr_expand.resident", "rrr_expand.streamed", "greedy_pick.resident",
    "greedy_pick.scan_ref", "lazy_greedy.resident", "bucket_insert.chunk",
    "bucket_insert.stream", "bucket_insert.scan_ref", "cascade.kernel",
    "service.batched"])
def test_shared_fixture_bit_identical_to_reference(name):
    """The reference's fixture (its Pallas kernels in interpret mode) and
    the port's, built from the same numpy seed and key, give the same
    bits.  The receivers' thresholds are an input both calls pass
    through: the reference's fixture builds them eagerly from a constant,
    which XLA folds otherwise than the traced pow its pipeline (and the
    port) evaluates, so they are held to the traced one here."""
    from repro.analysis import contracts as reference
    fn, args = reference.contracts_by_name()[name].build()
    want = _leaves(fn(*args))
    got = _leaves(contracts.contracts_by_name()[name].build(CPU).fn())
    assert len(got) == len(want)
    if name.startswith("bucket_insert."):
        from repro.core import streaming
        thr = jax.jit(lambda lo: streaming.init_state(5, 0.077, lo, 11)
                      .thresholds)(jnp.float32(10.0))
        np.testing.assert_array_equal(got.pop(), np.asarray(thr))
        want.pop()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if b.dtype == np.float32:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(u32(a), u32(b))


# ------------------------------------------------------------------ CLI
def test_cli_all_on_the_cpu(capsys):
    assert check.main(["--all", "--device", "cpu", "--repo-root",
                       REPO]) == 0
    out = capsys.readouterr().out
    assert "all checks passed" in out
    for c in contracts.build_registry():
        assert f"[  ok] {c.name}" in out


def test_cli_ast_json_report(tmp_path):
    path = tmp_path / "report.json"
    rc = check.main(["--ast", "--repo-root", REPO, "--json", str(path)])
    assert rc == 0
    payload = json.loads(path.read_text())
    assert payload["ok"] is True
    assert payload["contracts"] == []
    assert payload["ast"]["violations"] == []


def test_cli_single_contract(capsys):
    rc = check.main(["--contracts", "bucket.gains", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "bucket.gains" in out and "cascade.kernel" not in out


def test_cli_list(capsys):
    assert check.main(["--list"]) == 0
    out = capsys.readouterr().out
    for family in contracts.FAMILIES:
        assert f"[{family}]" in out


def test_cli_unknown_contract_rejected():
    with pytest.raises(SystemExit, match="unknown contract"):
        check.main(["--contracts", "nope.nothing", "--device", "cpu"])


def test_cli_card_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        check.main(["--contracts", "bucket.gains"])
