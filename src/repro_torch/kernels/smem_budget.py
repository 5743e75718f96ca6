"""The one model of the shared memory the hand-written kernels ask for
(twin of ``repro/kernels/vmem_budget.py``).

A block of the H100 may use up to 232,448 bytes of shared memory, static
and dynamic together, once a kernel opts in.  The kernels keep the
senders' covers, the receiver's share of a bucket's cover and the
cascade steps' key tables there, and size those from the shapes of the
launch.  This module computes every such figure:

- the budget (:func:`budget_bytes`): an explicit override, else the
  opt-in limit of the CUDA device, else (the CPU, where nothing
  launches) the H100's own figure, :data:`HOPPER_OPTIN_BYTES`, the card
  the kernels are built for;
- the dense senders' cover (``greedy_pick``, ``greedy_pick_compact``,
  ``lazy_greedy``, ``lazy_greedy_compact``, ``topk_gain``, ``coverage``:
  :func:`cover_bytes`) and the query axis's G covers
  (``*_batch``: :func:`group_cover_bytes`), with the group planner
  (:func:`query_budget`, :func:`query_groups`);
- the streaming receiver's share of a cover (:func:`receiver_cover_bytes`)
  and its stream's chunk (:func:`stream_chunk_capacity`,
  :func:`auto_chunk_size`);
- the compact layout's list (:func:`compact_capacity`, :func:`list_room`:
  device memory, not shared, but the same kind of room a launch is
  sized by);
- ``rrr_expand``'s cascade steps, which stage their key table
  (:func:`staged_key_bytes`).

:func:`launch_bytes` gives the dynamic figure of any launch name of
``ops.KERNELS``.  Each C library computes its own launch's figure with
the same arithmetic and exports it as ``launch_smem(launch, W, x)``
(``csrc/kernel_table.cuh``); the card tests and ``chip_smoke.py``'s
``contracts`` phase hold the two equal, and the checker
(``repro_torch.analysis``) adds each kernel's static shared memory and
compares the sum with the budget.  The C guards (-2, -5, -6 in
``ops._REFUSALS``) stay as each kernel's own last check.

Not ported from the reference: ``resolve_gather``'s VMEM solve and
``sampler_d_tile`` have no counterpart (``gather="auto"`` means the
resident push here, which stages nothing, and the coins are drawn in
the step), and the tuned tables wait for a twin of
``benchmarks/autotune.py``.  No figure here changes a result.
"""
from __future__ import annotations

import torch

# Shared memory a block may use on the H100 (sm_90) once a kernel opts
# in: 227 KB of the SM's 256 KB.
HOPPER_OPTIN_BYTES = 232_448
WORD_BYTES = 4
# The largest query group the query-axis kernels are built for
# (``kMaxGroup`` in ``csrc/greedy_core.cuh``).
MAX_GROUP = 8
# Static shared memory of each launch name's device functions on sm_90a
# (the largest of them; ``cudaFuncGetAttributes``' ``sharedSizeBytes``,
# which the card tests hold these to).  The query-axis kernels' figure
# (their G x 32 keys of scratch) is what the C side's
# ``<lib>_batch_budget`` takes from the opt-in limit.
STATIC_BYTES = {
    "rrr_expand_resident": 0, "rrr_expand_streamed": 0, "rrr_expand_ic": 0,
    "cascade_ic": 0, "rrr_expand_lt": 0, "cascade_lt": 0, "coin_pack": 0,
    "greedy_pick": 512, "bucket_insert": 4096, "coverage": 0,
    "topk_gain": 256, "lazy_greedy": 528, "bucket_insert_stream": 4096,
    "bucket_gains": 256, "greedy_pick_batch": 2112, "lazy_greedy_batch": 2208,
    "topk_gain_batch": 2048, "compact_rows": 3072, "greedy_pick_compact": 272,
    "lazy_greedy_compact": 16,
}
# The streaming receiver (``csrc/bucket_insert.cu``): threads a block,
# and its static per-pass sums (``PART_BYTES``: 2 x warps x 2 x group
# ints).
RECV_THREADS = 256
RECV_PART_BYTES = WORD_BYTES * 2 * (RECV_THREADS // 32) * 2 * 32
# The cascade steps stage their key table when it fits in this many
# bytes (``kSharedKeyBytes`` in ``csrc/rrr_expand.cu``).
SHARED_KEY_BYTES = 48 * 1024

# The machine axis's layout rule, set from both layouts forced on rows
# with 0.01% to 50% of their words non-zero at m = 2, 8 and 32
# (``tools/time_solves.py --axis sweep``, NVIDIA H100 80GB HBM3, 700 W).
# The compact picks run on one block a machine, where an entry costs
# 0.45-1.3 ns (a row of more than four entries takes the whole warp, one
# row at a time), and the list mostly misses L2 once it is long; the
# dense sweep streams every word over all SMs at about 1.3 ps a word.  So
# the compact layout pays while the list holds at most
# m' x (words / COMPACT_WORDS_PER_ENTRY + COMPACT_BLOCK_ENTRIES) entries,
# m' = min(m, COMPACT_MAX_MACHINES): a block's share of the list then
# costs it no more than the dense sweep costs the card, the second term
# standing for the dense sweep's grid-wide syncs in each pick.  m' stops
# at 16: at m = 32 the lazy solves crossed below m / 1024 of the words.
COMPACT_WORDS_PER_ENTRY = 1024
COMPACT_BLOCK_ENTRIES = 1024
COMPACT_MAX_MACHINES = 16

# The launch names whose dynamic figure is one cover of W words.
_COVER = ("greedy_pick", "greedy_pick_compact", "lazy_greedy",
          "lazy_greedy_compact", "topk_gain", "coverage")
# The launch names whose dynamic figure is x covers (x = G).
_GROUP = ("greedy_pick_batch", "lazy_greedy_batch", "topk_gain_batch")
# The launch names that stage nothing.
_NONE = ("rrr_expand_resident", "rrr_expand_streamed", "rrr_expand_ic",
         "rrr_expand_lt", "coin_pack", "compact_rows", "bucket_gains")

# The shapes of PERF.md section 4's full-size cells, by launch name:
# (cell, W, x) as :func:`launch_bytes` takes them.  ER n = 262,144 at
# avg degree 4 has a padded in-degree of 16 (one coin chunk), the
# supercritical ER n = 32,768 at 76.3 one of 112 (4 chunks of 32), and
# the IMM-size rmat graph one of 7,567 (237 chunks); spreads take 64
# simulations.  The LT push reads the CSR rows (no padded width): its
# ``g500_lt_s18`` shape is the benchmark cell's widest sampling call.
FULL_SIZE = {
    "rrr_expand_resident": (("wc resident", 2, 0),),
    "rrr_expand_streamed": (("imm streamed", 1024, 0),),
    "rrr_expand_ic": (("imm", 1024, 0), ("round", 512, 0),
                      ("serve slab", 128, 0)),
    "cascade_ic": (("imm", 2, 2 * 1 * 64), ("supercritical", 2, 2 * 4 * 64),
                   ("rmat", 2, 2 * 237 * 64)),
    "rrr_expand_lt": (("lt", 1024, 0), ("g500_lt_s18", 8192, 0)),
    "cascade_lt": (("lt", 2, 2 * 64),),
    "coin_pack": (("imm streamed", 1024, 0),),
    "greedy_pick": (("imm supercritical", 1024, 0),),
    "bucket_insert": (("imm", 1024, 1),),
    "coverage": (("ripples", 512, 0),),
    "topk_gain": (("round fused", 4096, 0),),
    "lazy_greedy": (("round supercritical", 1024, 0),),
    "bucket_insert_stream": (("round", 4096, 1),),
    "bucket_gains": (("receiver", 4096, 0),),
    "greedy_pick_batch": (("serve resident", 4096, MAX_GROUP),),
    "lazy_greedy_batch": (("serve lazy", 4096, MAX_GROUP),),
    "topk_gain_batch": (("serve fused", 4096, MAX_GROUP),),
    "compact_rows": (("imm", 1024, 0), ("round", 4096, 0)),
    "greedy_pick_compact": (("imm", 1024, 0), ("lt", 1024, 0)),
    "lazy_greedy_compact": (("round lazy", 4096, 0),),
}


def budget_bytes(device=None, override: int | None = None) -> int:
    """Shared memory a block may use: ``override`` when given, else the
    opt-in limit of a CUDA ``device``, else :data:`HOPPER_OPTIN_BYTES`
    (the CPU, where nothing launches, models the H100)."""
    if override is not None:
        return int(override)
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return int(props.shared_memory_per_block_optin)
    return HOPPER_OPTIN_BYTES


# -------------------------------------------------------------- senders
def cover_bytes(num_words: int) -> int:
    """One cover of ``num_words`` words: the dynamic shared memory of the
    machine-axis senders, the fused pick and the Ripples sweep."""
    return WORD_BYTES * num_words


def group_cover_bytes(g: int, num_words: int) -> int:
    """A query group's ``g`` covers: the query-axis kernels' figure."""
    return g * cover_bytes(num_words)


def query_budget(lib: str, device=None) -> int:
    """Shared memory a block of ``lib``'s query-axis kernel may give to
    covers: the opt-in limit less the kernel's static scratch.  On a CUDA
    ``device`` the C side's ``<lib>_batch_budget`` (the figure its launch
    checks); without one the H100's, from :data:`STATIC_BYTES`."""
    if device is None:
        return budget_bytes() - STATIC_BYTES[f"{lib}_batch"]
    from repro_torch.kernels import build

    with torch.cuda.device(device):
        budget = int(build.function(lib, f"{lib}_batch_budget", [])())
    if budget <= 0:
        raise RuntimeError(f"{lib}: CUDA error {-budget} reading the "
                           "shared-memory budget")
    return budget


def query_groups(b: int, num_words: int, budget: int) -> tuple[int, int]:
    """(G, groups) for B queries of ``num_words``-word covers when a block
    may give ``budget`` bytes of shared memory to covers: G is as many
    queries as the budget and :data:`MAX_GROUP` allow, at most B, and
    the last group holds the rest (12 queries go 8 + 4).  A cover wider
    than the budget still gets G = 1, and the kernel refuses it."""
    if b < 1:
        raise ValueError(f"need at least one query, got {b}")
    g = max(1, min(MAX_GROUP, b, budget // cover_bytes(num_words)))
    return g, -(-b // g)


# ------------------------------------------------------------- receiver
def receiver_cluster(num_words: int, vec: bool = True) -> int:
    """Blocks a bucket of the streaming receiver: two once one block's
    threads would hold more than one unit (16 bytes with ``vec``, else
    4) of a row each, else one."""
    units = num_words // 4 if vec else num_words
    return 2 if units > RECV_THREADS else 1


def receiver_cover_bytes(num_words: int, vec: bool = True) -> int:
    """A receiver block's share of its bucket's cover, in whole units
    (``vec``: rows and covers 16-byte aligned, W a multiple of 4)."""
    unit = 16 if vec else WORD_BYTES
    cs = receiver_cluster(num_words, vec)
    return (num_words // (unit // WORD_BYTES) + cs - 1) // cs * unit


def stream_chunk_capacity(num_words: int, device=None) -> int:
    """The largest count of candidates whose double buffer ([2, C, W]
    words) fits a receiver block next to one cover and its per-pass
    sums (0 when none does): the chunk of the pipelined receiver, which
    the stream kernel refuses (-5) below 1."""
    if num_words <= 0:
        return 0
    avail = (budget_bytes(device) - RECV_PART_BYTES
             - WORD_BYTES * (-(-num_words // 4) * 4))
    return avail // (2 * cover_bytes(num_words)) if avail > 0 else 0


def auto_chunk_size(num_words: int, total: int, device) -> int:
    """The pipelined receiver's chunk size (stands in for the reference's
    ``vmem_budget.receiver_chunk_size``): on a CUDA device the stream's
    chunk capacity, at least 1; on the CPU the whole stream.  At most
    the stream; results never depend on it."""
    if torch.device(device).type == "cuda":
        c = max(1, stream_chunk_capacity(num_words, device))
    else:
        c = max(1, total)
    return min(c, total) if total > 0 else c


# ------------------------------------------------------- compact layout
def compact_capacity(words: int, m: int) -> int:
    """The longest list of ``words`` dense words over ``m`` machines on
    which the compact layout pays (the constants above)."""
    return min(m, COMPACT_MAX_MACHINES) * (
        words // COMPACT_WORDS_PER_ENTRY + COMPACT_BLOCK_ENTRIES)


def list_room(m: int, n: int, w: int) -> int:
    """Entries of the one list allocation of rows [m, n, W]: the longest
    list the compact layout takes, at most every word.  Also the
    residual at which a dense solve hands over
    (``greedy_pick.greedy_dense``)."""
    return min(compact_capacity(m * n * w, m), m * n * w)


# ------------------------------------------------------------- cascades
def staged_key_bytes(words: int) -> int:
    """The shared memory a cascade step (``cascade_ic``: 2 x n_chunks x
    num_sims words; ``cascade_lt``: 2 x num_sims) stages its key table
    in: all of it when it fits in :data:`SHARED_KEY_BYTES`, else none."""
    nbytes = WORD_BYTES * words
    return nbytes if nbytes <= SHARED_KEY_BYTES else 0


# ----------------------------------------------------------------- all
def launch_bytes(kernel: str, num_words: int, x: int = 0) -> int:
    """The dynamic shared memory the launch ``kernel`` (a name of
    ``ops.KERNELS``) asks for at ``num_words`` words, ``x`` being its
    second figure: the group size G of the query axis, 1 for the
    receivers' 16-byte units (0: 4-byte ones), the cascades' key table
    words.  The C side's ``launch_smem`` computes the same."""
    if kernel in _COVER:
        return cover_bytes(num_words)
    if kernel in _GROUP:
        return group_cover_bytes(x, num_words)
    if kernel in ("bucket_insert", "bucket_insert_stream"):
        return receiver_cover_bytes(num_words, bool(x))
    if kernel in ("cascade_ic", "cascade_lt"):
        return staged_key_bytes(x)
    if kernel in _NONE:
        return 0
    raise ValueError(f"unknown launch {kernel!r}")
