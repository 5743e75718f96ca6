"""The port's token pipeline and coreset selector (``repro_torch.data``)
against the reference's ``repro.data.pipeline``: the tokens bit for bit
over several seeds, steps and vocabularies, the document signatures,
and the coreset's ids and coverage on both routes (streaming through
the pipelined receiver, greedy through the resident solver)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import pipeline as ref  # noqa: E402
from repro_torch.core import maxcover  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401


def _pipes(**kw):
    return (ref.TokenPipeline(ref.DataConfig(**kw)),
            pipeline.TokenPipeline(pipeline.DataConfig(**kw), device="cpu"))


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1000, 32, 4, 7), (256, 16, 2, 0), (50, 9, 3, 123), (997, 24, 5, 2**30)])
def test_tokens_bit_for_bit(vocab, seq, batch, seed):
    want_p, got_p = _pipes(vocab_size=vocab, seq_len=seq, global_batch=batch,
                           seed=seed)
    for step in (0, 1, 5, 1000):
        for extra in (True, False):
            got = got_p.batch(step, extra_token=extra)
            want = np.asarray(want_p.batch(step, extra_token=extra))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_iteration_and_repetition_statistics():
    _, p = _pipes(vocab_size=1000, seq_len=256, global_batch=8, seed=3)
    it = iter(p)
    first, second = next(it), next(it)
    assert torch.equal(first, p.batch(0)) and torch.equal(second, p.batch(1))
    rep = (first[:, 1:] == first[:, :-1]).float().mean()
    assert 0.25 < float(rep) < 0.45          # repeat_p = 0.3 plus chance


@pytest.mark.parametrize("ngram,universe", [(2, 4096), (3, 1024), (1, 64)])
def test_doc_signature_exact(ngram, universe):
    rng = np.random.default_rng(ngram)
    docs = rng.integers(0, 200000, (5, 40))
    r = ref.CoresetSelector(universe=universe, ngram=ngram)
    p = pipeline.CoresetSelector(universe=universe, ngram=ngram,
                                 device="cpu")
    for d in docs:
        got, want = p.doc_signature(d), np.asarray(r.doc_signature(d))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def _docs(seed: int, n: int, s: int, vocab: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (n, s))


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("seed,n,s,vocab,k,universe", [
    (0, 32, 64, 5000, 8, 1024), (1, 16, 129, 256, 8, 1024),
    (2, 40, 33, 50, 5, 4096), (3, 9, 20, 1000, 9, 256)])
def test_coreset_ids_and_coverage_exact(streaming, seed, n, s, vocab, k,
                                        universe):
    docs = _docs(seed, n, s, vocab)
    want_ids, want_cov = ref.CoresetSelector(universe=universe).select(
        docs, k, use_streaming=streaming)
    ops.reset_launches()
    got_ids, got_cov = pipeline.CoresetSelector(
        universe=universe, device="cpu").select(docs, k,
                                                use_streaming=streaming)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    assert got_cov == want_cov
    assert not any(ops.LAUNCHES.values())


def test_coreset_on_pipeline_pools_exact():
    """The launcher's pools: two batches of the pipeline's own tokens."""
    want_p, got_p = _pipes(vocab_size=256, seq_len=16, global_batch=4,
                           seed=0)
    docs = np.concatenate([got_p.batch(0).numpy(), got_p.batch(1).numpy()])
    np.testing.assert_array_equal(
        docs, np.concatenate([np.asarray(want_p.batch(0)),
                              np.asarray(want_p.batch(1))]))
    want = ref.CoresetSelector(universe=1024).select(docs, 4)
    got = pipeline.CoresetSelector(universe=1024, device="cpu").select(
        docs, 4)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]


def test_coreset_beats_random_coverage():
    rng = np.random.default_rng(0)
    # half the docs are near-duplicates; coreset should avoid them
    base = rng.integers(0, 50, size=(1, 64))
    dupes = np.repeat(base, 16, axis=0) + rng.integers(0, 2, (16, 64))
    diverse = rng.integers(0, 5000, size=(16, 64))
    docs = np.concatenate([dupes, diverse])
    sel = pipeline.CoresetSelector(universe=1024, device="cpu")
    picked, cov = sel.select(docs, 8)
    rows = np.stack([sel.doc_signature(d) for d in docs])
    rand_cov = maxcover.coverage_of(rows, list(range(8)))  # first 8=dupes
    assert cov > rand_cov
    assert (np.asarray(picked) >= 16).sum() >= 5  # mostly diverse docs


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.CoresetSelector()
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.TokenPipeline(pipeline.DataConfig(10, 4, 1))
