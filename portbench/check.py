"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``portbench/reference``), each number
beside its limit.

IMM cells (the window's last selection, keyed ``key(seed).fold_in(i)``):

* ``sampler_off``: samples of the selection's final incidence that are
  wrong -- every sample whose own root is missing, every sample whose
  RRR set differs from the reference's, and every sample past the
  reference's theta that holds anything.  With ``check_per_word`` 0 the
  reference draws every sample; otherwise it compares that many samples
  of every 32-sample word of the incidence, drawn from the seed (and
  every sample's root).  A sample's set spans every vertex, so every
  machine's rows are compared with it;
* ``selection_off``: selector calls whose width, key, seeds or coverage
  differ from the reference's RandGreedi (a call missing or extra counts
  one), plus IMM's seeds, coverage fraction, theta, rounds and LB where
  they differ from the reference's rounds.  Where the reference draws
  every sample it selects over its own incidence; where it draws a
  sample of them it follows the program's incidence, which
  ``sampler_off`` checks on its own.

Serve cells:

* ``serve_off``: samples of either pool half whose RRR set differs from
  the reference's pool, drawn again in full; queries of a sample drawn
  from the seed whose answer (seeds, k_used, coverage, spread, both
  bounds, guarantee, certified) differs from the reference's over its
  own pool; and admitted queries that got no answer.  One count: the
  control (``control.py``) moves the pool on every seed and the answers
  only on some.

Every number is a count of exact disagreements, so its limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import cover, sampler
from portbench.reference import imm as ref_imm
from portbench.reference import service as ref_service
from portbench.reference.threefry import Key

# the control's precision: the one below the configurations' float32
LOW = "bfloat16"


def entries_of(rows: torch.Tensor, block: int = 1 << 14) -> cover.Entries:
    """The non-zero words of a packed int32 incidence [n, W]."""
    parts = [], [], []
    for lo in range(0, rows.shape[0], block):
        r, w = torch.nonzero(rows[lo:lo + block], as_tuple=True)
        parts[0].append(r + lo)
        parts[1].append(w)
        parts[2].append(rows[lo:lo + block][r, w].to(torch.int64)
                        & 0xFFFFFFFF)
    cat = [torch.cat(p) if p else torch.zeros(0, dtype=torch.int64,
                                                device=rows.device)
           for p in parts]
    return cover.Entries(cat[0], cat[1], cat[2], rows.shape[0],
                         rows.shape[1])


def pairs_at(e: cover.Entries, cols=None, block: int = 1 << 22):
    """(sample, vertex) of the incidence's set bits, at the distinct
    samples ``cols`` (None: all), a block of entries at a time, each
    entry masked to the checked samples of its word before its bits are
    listed."""
    mask = None
    if cols is not None:
        mask = torch.zeros(e.words, dtype=torch.int64, device=e.bits.device)
        mask.index_add_(0, cols // 32, torch.ones_like(cols) << (cols % 32))
    bit = torch.arange(32, device=e.bits.device)
    samples, vertices = [], []
    for lo in range(0, e.bits.numel(), block):
        row, word, bits = (t[lo:lo + block] for t in (e.row, e.word,
                                                       e.bits))
        if mask is not None:
            bits = bits & mask[word]
            keep = bits != 0
            row, word, bits = row[keep], word[keep], bits[keep]
        i, b = torch.nonzero((bits[:, None] >> bit) & 1, as_tuple=True)
        samples.append(word[i] * 32 + b)
        vertices.append(row[i])
    if not samples:
        empty = torch.zeros(0, dtype=torch.int64, device=e.bits.device)
        return empty, empty
    return torch.cat(samples), torch.cat(vertices)


def differing(a, b, n: int) -> torch.Tensor:
    """The samples whose sets differ between pair lists a and b."""
    u, c = torch.unique(torch.cat([a[0] * n + a[1], b[0] * n + b[1]]),
                        return_counts=True)
    return torch.unique(u[c == 1] // n)


def has_bit(e: cover.Entries, rows, cols) -> torch.Tensor:
    """bool: does the incidence hold (rows[i], cols[i])?"""
    code = e.row * e.words + e.word
    want = rows * e.words + cols // 32
    at = torch.searchsorted(code, want).clamp(max=max(code.numel() - 1, 0))
    if not code.numel():
        return torch.zeros(want.shape, dtype=torch.bool, device=want.device)
    found = code[at] == want
    return found & (((e.bits[at] >> (cols % 32)) & 1) == 1)


def check_columns(cfg: dict, seed: int, unit: int, theta: int, device):
    """The samples whose sets the sampler check compares, ascending:
    ``check_per_word`` distinct samples of every 32-sample word (every
    sample where that is 32 or more), drawn from the seed."""
    per = cfg["check_per_word"]
    if per >= 32:
        return torch.arange(theta, device=device)
    words = -(-theta // 32)
    rng = np.random.default_rng([int(seed), int(unit), 0xC01])
    offsets = np.argsort(rng.random((words, 32)), axis=1)[:, :per]
    cols = (np.arange(words)[:, None] * 32 + offsets).ravel()
    cols = np.sort(cols[cols < theta])
    return torch.as_tensor(cols, dtype=torch.int64, device=device)


def full_check(cfg: dict) -> bool:
    """Does the reference draw every sample (``check_per_word`` 0)?"""
    return not cfg.get("check_per_word", 0)


def reference_run(rg, cfg: dict, seed: int, unit: int, inc: cover.Entries,
                  precision: str = "float32"):
    """IMM's rounds in the reference -> (draws, its own incidence or
    None, calls, result).  Where it draws every sample itself
    (:func:`full_check`) it selects over its own incidence; otherwise it
    follows ``inc``, the incidence under test, whose samples the sampler
    check compares by a sample drawn from the seed."""
    full = full_check(cfg)
    pairs = ([], [])

    def on_draw(d):
        if full:
            b, v = sampler.draw(rg, d.key,
                                torch.arange(d.count, device=rg.device),
                                model=cfg["model"],
                                max_steps=cfg["max_steps"],
                                precision=precision)
            pairs[0].append(b + d.start)
            pairs[1].append(v)

    def own(words):
        return cover.from_pairs(torch.cat(pairs[0]), torch.cat(pairs[1]),
                                rg.n, words * 32)

    def select(words, sub):
        src = own(words) if full else inc.prefix(words)
        return cover.randgreedi(src, sub, m=cfg["machines"], k=cfg["k"],
                                delta=cfg["delta"], precision=precision)
    key = Key.from_seed(seed).fold_in(unit)
    draws, calls, result = ref_imm.imm(rg.n, cfg["k"], cfg["eps"], key,
                                       cfg["max_theta"], select, on_draw)
    calls = [(c.words, (c.key.k0, c.key.k1), c.seeds, c.coverage)
             for c in calls]
    return (draws, own(result.theta // 32) if full else None, calls,
            tuple(result))


def sampler_off(rg, cfg: dict, seed: int, unit: int, inc: cover.Entries,
                draws, own=None) -> int:
    """Samples of ``inc`` that are wrong: against the reference's own
    incidence ``own`` where it drew every sample, else at the samples
    drawn from the seed."""
    theta = sum(d.count for d in draws)
    dev = inc.bits.device
    cols = None if own is not None else \
        check_columns(cfg, seed, unit, theta, dev)
    bad = []
    for d in draws:
        local = torch.arange(d.count, device=dev)
        roots = sampler.roots(rg, d.key, local)
        bad.append((local + d.start)[~has_bit(inc, roots, local + d.start)])
        if cols is None:
            continue
        local = cols[(cols >= d.start) & (cols < d.start + d.count)] \
            - d.start
        b, v = sampler.draw(rg, d.key, local, model=cfg["model"],
                            max_steps=cfg["max_steps"])
        bad.append(differing((b + d.start, v), pairs_at(inc, local + d.start),
                             rg.n))
    if own is not None:
        bad.append(differing(pairs_at(own), pairs_at(inc), rg.n))
    extra = inc.word >= theta // 32
    if bool(extra.any()):
        bad.append(pairs_at(cover.Entries(inc.row[extra], inc.word[extra],
                                          inc.bits[extra], inc.n,
                                          inc.words))[0])
    return int(torch.unique(torch.cat(bad)).numel())


def selection_off(ref_calls, ref_result, calls, result) -> int:
    off = abs(len(ref_calls) - len(calls))
    off += sum(tuple(a) != tuple(b) for a, b in zip(ref_calls, calls))
    off += sum(a != b for a, b in zip(ref_result, result))
    return off


def imm_numbers(rg, cfg: dict, seed: int, unit: int, inc: cover.Entries,
                calls, result) -> dict:
    """The IMM cell's numbers for one selection: ``inc`` its final
    incidence, ``calls`` its selector calls as (words, (k0, k1), seeds,
    coverage) and ``result`` as (seeds, coverage fraction, theta,
    rounds, lb)."""
    draws, own, ref_calls, ref_result = reference_run(rg, cfg, seed, unit,
                                                      inc)
    return {"sampler_off": sampler_off(rg, cfg, seed, unit, inc, draws, own),
            "selection_off": selection_off(ref_calls, ref_result, calls,
                                           result)}


def pool_entries(rg, cfg: dict, seed: int, salt: int,
                 precision: str = "float32"):
    """The reference's pool: both halves, ``pool_theta`` samples each in
    slabs keyed key.fold_in(half).fold_in(slab).fold_in(salt)."""
    theta, slab = cfg["pool_theta"], cfg["slab"]
    key = Key.from_seed(seed)
    halves = []
    for h in (0, 1):
        kh = key.fold_in(h)
        bs, vs = [], []
        local = torch.arange(slab, device=rg.device)
        for s in range(theta // slab):
            b, v = sampler.draw(rg, kh.fold_in(s).fold_in(salt), local,
                                model=cfg["model"],
                                max_steps=cfg["max_steps"],
                                precision=precision)
            bs.append(b + s * slab)
            vs.append(v)
        halves.append(cover.from_pairs(torch.cat(bs), torch.cat(vs), rg.n,
                                       theta))
    return halves


def serve_numbers(ref_halves, halves, ref_answers, answers,
                  unanswered: int) -> tuple[dict, dict]:
    """The serve cell's number and its parts."""
    parts = {"pool_off": pool_off(ref_halves, halves),
             "answers_off": answers_off(ref_answers, answers),
             "unanswered": unanswered}
    return {"serve_off": sum(parts.values())}, parts


def pool_off(ref_halves, halves) -> int:
    off = 0
    for a, b in zip(ref_halves, halves):
        off += int(differing(pairs_at(a), pairs_at(b), a.n).numel())
    return off


def answers_off(ref_answers, answers) -> int:
    return sum(tuple(a) != tuple(b) for a, b in zip(ref_answers, answers))


def reference_answers(halves, queries, cfg: dict, group: int = 16,
                      precision: str = "float32"):
    out = []
    for lo in range(0, len(queries), group):
        out += ref_service.answers(
            halves[0], halves[1], queries[lo:lo + group],
            theta=cfg["pool_theta"], delta=cfg["fail_prob"],
            alpha=1.0 - 1.0 / np.e, precision=precision)
    return out


def answer_fields(a) -> tuple:
    """A program answer in the reference's field order."""
    return (tuple(int(x) for x in a.seeds), int(a.k_used), int(a.coverage),
            float(a.spread), float(a.sigma_lower), float(a.sigma_upper),
            float(a.guarantee), bool(a.certified))


def sample_queries(count: int, seed: int, size: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 0xA5])
    return np.sort(rng.choice(count, size=min(size, count), replace=False))
