"""The LT push's least traffic in a window, from the program's counters
(``rrr.rrr_batch_packed`` with a ``stats`` dict): the bound that
``metrics/rrr.lt_roofline.py`` holds the push's device time to.

Per listed word (``frontier_words``): its list entry and the word read
(8 B) and its row's two offsets (8 B).  Per cumulative weight a choice
reads (``choice_reads``: a binary search's ceil(log2 deg) + 1 a draw, at
most the row's sums a step): 4 B.  Every live bit past the roots
(``frontier_bits - root_bits``) was set by an edge taken, whose source
is read (4 B each; more edges may be taken).  Every listed word past
the roots' (at least ``frontier_words - root_bits`` of them: the roots'
words are at most their bits) was appended once (4 B) and hit once, its
visited and next-plane words read, modified and written (16 B).  Each
term counts what the data needs at the least, so the bound lies at or
below the push's least time over HBM.
"""
from __future__ import annotations

from portbench import counts

KEYS = ("frontier_words", "frontier_bits", "root_bits", "choice_reads")


def push_bytes(words: int, bits: int, roots: int, reads: int) -> int:
    later_bits = max(bits - roots, 0)
    appended = max(words - roots, 0)
    return 16 * words + 4 * reads + 4 * later_bits + 20 * appended


def bound_s(stats: dict):
    """Seconds the counted traffic takes over HBM, or None where the
    program counted none of it."""
    if not all(k in stats for k in KEYS):
        return None
    return counts.bound_s(push_bytes(*(int(stats[k]) for k in KEYS)))
