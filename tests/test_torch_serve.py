"""The slice as a whole: ``serve.main --check`` on the CPU prints the
reference's ``[serve]`` lines (seconds and queries/s masked) and exits
0; the supervised replay under injected faults, and a kill and resume,
give the clean replay's answers; ``im_driver --serve`` routes here."""
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.launch import serve as ref  # noqa: E402
from repro_torch.launch import im_driver, serve  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

BASE = ["--n", "96", "--queries", "12", "--batch", "4", "--theta0", "128",
        "--slab", "64", "--max-theta", "512", "--k-max", "5"]


def _lines(text):
    out = []
    for ln in text.splitlines():
        if ln.startswith("[serve]"):
            ln = re.sub(r" in [0-9.]+s \([0-9.]+ queries/s\)",
                        " in Xs (Y queries/s)", ln)
            out.append(re.sub(r"ckpt=\S+,", "ckpt=D,", ln))
    return out


@pytest.mark.parametrize("flags", [
    ["--solver", "resident", "--refresh-every", "1"],
    ["--solver", "lazy", "--model", "LT", "--refresh-every", "2",
     "--sampler", "dense"],
    ["--solver", "fused", "--graph", "ba", "--avg-deg", "3",
     "--sampler", "packed"],
])
def test_check_prints_the_reference_lines(flags, capsys):
    assert ref.main(BASE + flags + ["--check"]) == 0
    want = _lines(capsys.readouterr().out)
    out = serve.run(BASE + flags + ["--check", "--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert len(want) == 3 and want[-1].startswith("[serve] check OK")
    assert got == want
    assert out["rc"] == 0 and out["mismatches"] == 0
    assert out["stats"]["solves"] >= 3 and out["stats"]["refreshes"] >= 1


def test_supervised_replay_recovers_the_clean_answers(capsys):
    """``--recover --inject service.answer:raise:1``: the fault is
    retried (or the snapshot restored) and every answer equals a clean
    replay's; the reference prints the same lines."""
    flags = BASE + ["--refresh-every", "1", "--recover", "--inject",
                    "service.answer:raise:1", "--inject",
                    "checkpoint.write:write_fail:0", "--retries", "1",
                    "--check"]
    assert ref.main(flags) == 0
    want = _lines(capsys.readouterr().out)
    got_run = serve.run(flags + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want and got[-1].startswith("[serve] check OK")
    clean = serve.run(BASE + ["--refresh-every", "1", "--recover",
                              "--device", "cpu"])
    assert got_run["fired"] == 2 and clean["fired"] == 0
    assert all(serve.answers_equal(a, b)
               for a, b in zip(got_run["answers"], clean["answers"]))
    assert len(got_run["answers"]) == 12


def test_kill_and_resume_equal_the_clean_replay(tmp_path, capsys):
    common = BASE + ["--refresh-every", "1", "--recover", "--ckpt-dir",
                     str(tmp_path), "--device", "cpu"]
    first = serve.run(common + ["--kill-after", "2"])
    rest = serve.run(common + ["--resume-from", "2", "--check"])
    assert rest["rc"] == 0 and rest["mismatches"] == 0
    clean = serve.run(BASE + ["--refresh-every", "1", "--recover",
                              "--device", "cpu"])
    both = first["answers"] + rest["answers"]
    assert len(both) == 12
    assert all(serve.answers_equal(a, b)
               for a, b in zip(both, clean["answers"]))


@pytest.mark.parametrize("flags,needle", [
    (["--inject", "service.answer:raise"], "--inject requires --recover"),
    (["--kill-after", "1"], "require --recover"),
    (["--recover", "--resume-from", "1"], "needs --ckpt-dir"),
    (["--recover", "--retries", "-1"], "--retries must be >= 0"),
    (["--recover", "--inject", "bogus:raise"], "unknown injection site"),
])
def test_flag_errors_as_reference(flags, needle, capsys):
    for main in (ref.main, lambda a: serve.main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as ei:
            main(BASE + flags)
        assert ei.value.code == 2
        assert needle in capsys.readouterr().err


def test_im_driver_serve_routes_to_the_replay(capsys):
    flags = ["--n", "80", "--k", "4", "--max-theta", "256",
             "--solver", "lazy", "--sampler", "packed", "--serve"]
    out = im_driver.run(flags + ["--device", "cpu"])["serve"]
    lines = _lines(capsys.readouterr().out)
    assert out["rc"] == 0 and lines[-1].startswith("[serve] check OK")
    assert im_driver.main(flags + ["--device", "cpu"]) == 0
    assert all(len(a.seeds) <= 4 for a in out["answers"])
    assert isinstance(out["answers"][0].seeds, np.ndarray)
