"""The port stands alone and never falls back: it imports nothing of jax
or ``repro``, CUDA requests without a card raise, CPU tensors take the
plain versions without counting a launch, and flags that used to be
refused run and equal their plain twins."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import (bucket, bucket_insert, coins,  # noqa: E402
                                 coverage, greedy_pick, lazy_greedy, ops,
                                 rrr_expand, topk_gain)
from repro_torch.launch import im_driver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POISONED_IMPORTS = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]))
    out = subprocess.run([sys.executable, "-c", POISONED_IMPORTS], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        im_driver.main(["--n", "50", "--k", "2", "--max-theta", "64",
                        "--device", "cuda"])


def test_cpu_tensors_take_plain_versions_without_launches():
    ops.reset_launches()
    g = torch.Generator().manual_seed(0)

    def w(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             dtype=torch.int32)
    n, df, width = 9, 3, 2
    frontier, visited = w(n, width), w(n, width)
    nbr = torch.randint(0, n, (n, df), generator=g, dtype=torch.int32)
    gidx = torch.randint(0, 2 * n + 1, (n, df), generator=g,
                         dtype=torch.int32)
    plane = w(2 * n, width)
    got = rrr_expand.rrr_expand_step_resident(frontier, visited, nbr, gidx,
                                              plane)
    want = rrr_expand.expand_step_resident_plain(frontier, visited, nbr,
                                                 gidx, plane)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gmask = w(n, df, width)
    rrr_expand.rrr_expand_step(frontier, visited, nbr, gmask)
    coins.coin_plane([prng.key(1)], torch.full((n, 4), 0.5), frontier, 4)
    rrr_expand.rrr_expand_step_ic(frontier, visited, nbr,
                                  torch.full((n, 4), 0.5), [prng.key(1)], 4)
    rrr_expand.cascade_step_ic(
        frontier, visited, nbr, torch.full((n, df), 0.5),
        rrr_expand.cascade_keys(prng.key(1), 1, 64, "cpu"), df, 64,
        count=torch.zeros(1, dtype=torch.int32))
    cumw, lt_rows = rrr_expand.lt_tables(
        nbr, torch.linspace(0.2, 1.0, df).expand(n, df))
    indptr = torch.arange(0, n * df + 1, df, dtype=torch.int32)
    rrr_expand.rrr_expand_step_lt(frontier, visited, indptr, nbr.reshape(-1),
                                  cumw.reshape(-1).contiguous(), prng.key(1))
    rrr_expand.cascade_step_lt(
        frontier, visited, nbr, cumw, lt_rows,
        rrr_expand.lt_cascade_keys(prng.key(1), 64, "cpu"), 64,
        count=torch.zeros(1, dtype=torch.int32))
    greedy_pick.greedy_maxcover_resident(w(2, n, width), 3)
    bucket_insert.bucket_insert_chunk(
        torch.arange(4, dtype=torch.int32), w(4, width), w(3, width),
        torch.zeros(3, dtype=torch.int32),
        torch.full((3, 2), -1, dtype=torch.int32), torch.zeros(3))
    rows = w(2, n, width)
    cov = w(2, width)
    coverage.marginal_gain(rows, cov)
    topk_gain.best_gain_index(rows, cov, torch.zeros((2, n), dtype=torch.bool))
    lazy_greedy.greedy_maxcover_lazy(rows, 3)
    bucket_insert.bucket_insert_stream(
        torch.arange(4, dtype=torch.int32).reshape(2, 2), w(2, 2, width),
        w(3, width), torch.zeros(3, dtype=torch.int32),
        torch.full((3, 2), -1, dtype=torch.int32), torch.zeros(3))
    bucket.bucket_gains(w(width), w(3, width))
    shared, ex = w(n, width), torch.tensor([[1], [-1]], dtype=torch.int32)
    greedy_pick.greedy_maxcover_resident_batch(shared, 3, ex)
    lazy_greedy.greedy_maxcover_lazy_batch(shared, 3, ex)
    topk_gain.best_gain_index_batch(shared, cov,
                                    torch.zeros((2, n), dtype=torch.bool))
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)


PLAIN = ["--sampler", "packed", "--solver", "scan", "--eval-engine",
         "packed"]


@pytest.mark.parametrize("flags", [
    ["--theta", "256", "--machines", "4", "--solver", "lazy",
     "--use-kernel", "--chunk-size", "auto"],
    ["--selector", "ripples", "--machines", "4"],
    ["--solver", "lazy", "--use-kernel", "--machines", "4"],
    ["--solver", "fused", "--use-kernel", "--machines", "4"],
    ["--use-opim", "--solver", "lazy", "--use-kernel", "--machines", "4"],
    ["--use-opim", "--selector", "greedy"],
    ["--sampler", "dense", "--machines", "4"],
    ["--sampler", "dense", "--theta", "256", "--machines", "2"],
    ["--eval-spread", "--machines", "4"],
    ["--eval-engine", "map", "--machines", "4"],
    ["--faults", "local.greedy:drop:1", "--theta", "256", "--machines", "4"],
    ["--faults", "local.greedy:nan:0", "--faults", "receiver.insert:raise:0",
     "--theta", "256", "--machines", "4", "--solver", "lazy",
     "--fault-report", "{tmp}"],
])
def test_ported_paths_equal_their_plain_twin(flags, tmp_path):
    """Paths that used to be refused now run on the CPU and give what
    the plain paths (packed sampler, scan solver and receiver, packed
    spread engine) give; a fault report is the same file."""
    base = ["--n", "60", "--k", "3", "--max-theta", "256", "--device",
            "cpu"]
    got = im_driver.run(base + [f.format(tmp=tmp_path / "got.json")
                                for f in flags])
    plain = [f.format(tmp=tmp_path / "want.json") for f in flags
             if f not in ("--use-kernel",)]
    for flag in ("--solver", "--chunk-size"):
        if flag in plain:
            i = plain.index(flag)
            del plain[i:i + 2]
    want = im_driver.run(base + plain + PLAIN)
    assert set(got) == set(want)
    keys = (("seeds", "survivors", "alpha_used", "coverage", "spread", "rc",
             "theta") if "--faults" in flags else
            ("seeds", "theta", "rounds", "coverage_fraction", "guarantee",
             "spread", "round", "spread_check"))
    for key in keys:
        if key == "seeds":
            assert got[key].tolist() == want[key].tolist()
        elif key in ("round", "spread_check") and got[key] is not None:
            assert {k: v for k, v in got[key].items() if k != "seconds"} == \
                {k: v for k, v in want[key].items() if k != "seconds"}
        else:
            assert got[key] == want[key]
    if "--eval-spread" in flags:
        assert set(got["spread_check"]["spread"].values()) == {got["spread"]}
    if "--faults" in flags:
        assert got["rc"] == 0 and len(got["survivors"]) == 3
    if "--fault-report" in flags:
        reports = [json.loads((tmp_path / f"{name}.json").read_text())
                   for name in ("got", "want")]
        for report in reports:      # the monitor's flags read the clock
            report["checks"][0].pop("straggler_flags")
        assert reports[0] == reports[1] and reports[0]["pass"] is True
        assert [e["kind"] for e in reports[0]["events"]] == ["nan", "raise"]


def test_fault_report_needs_faults(capsys):
    """--fault-report alone exits through argparse, as the reference's
    driver does."""
    with pytest.raises(SystemExit) as e:
        im_driver.main(["--n", "50", "--device", "cpu", "--fault-report",
                        "x"])
    assert e.value.code == 2
    assert "--fault-report needs --faults" in capsys.readouterr().err


def test_all_partitions_lost_exit_status(tmp_path):
    """A plan that loses every machine returns status 1 and writes a
    report whose check failed."""
    path = tmp_path / "report.json"
    rc = im_driver.main(["--n", "60", "--k", "3", "--theta", "256",
                         "--machines", "2", "--device", "cpu", "--faults",
                         "local.greedy:drop:0", "--faults",
                         "local.greedy:raise:1", "--fault-report", str(path)])
    report = json.loads(path.read_text())
    assert rc == 1 and report["pass"] is False
    assert report["checks"][0]["name"] == "round_survived"
