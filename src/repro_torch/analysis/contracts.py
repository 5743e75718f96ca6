"""Kernel contract registry: each kernel family's launch, layout, dtype
and shared-memory invariants, declared once and proved by running
canonical fixtures (twin of ``repro/analysis/contracts.py``).

A :class:`KernelContract` binds together

* a *declaration*, the invariants that live next to the kernel source
  (module-level ``CONTRACT`` dicts in ``kernels/rrr_expand.py``,
  ``kernels/greedy_pick.py``, ``kernels/lazy_greedy.py``,
  ``kernels/bucket_insert.py``, ``kernels/topk_gain.py``,
  ``kernels/coverage.py``, ``kernels/bucket.py``, ``core/cascade.py``,
  ``core/service.py``): the launches of one call by kernel name (or of
  one step of the call's loop, ``per_step``), the dtype whitelist, and
  the launches whose device functions may keep a stack frame in local
  memory;
* a *fixture*, a small canonical call built here (the reference's: ER
  n = 48 at avg degree 4, theta = 64, a [64, 4] row pool, a 5-seed
  stream of 11 words) with the shapes each of its launches asks shared
  memory for;
* *layout patterns*, tensors the call must or must not build (the
  resident sampler's forbidden ``[n, d_out, W]`` mask, the streamed
  layout's required one).

:func:`run_contract` runs the fixture under a
:class:`~repro_torch.analysis.trace_check.Recorder` and checks, on a
CUDA device: the exact launches of every kernel (``ops.LAUNCHES``
deltas, and the recorder's own count of them), the layout patterns and
the dtypes of every op the wrappers issue, and each launched kernel's
shared memory (its static shared memory from ``cudaFuncGetAttributes``
plus ``kernels/smem_budget.py``'s dynamic figure, against the opt-in
limit; the model equal to the C side's ``launch_smem`` and to the
static figure it keeps; no local memory unless declared; the cooperative
launches' blocks co-resident).  On the CPU the same fixtures run the
plain versions: no launch at all, the same layout and dtype rules, and
the model's footprint against the H100's opt-in limit.

Not applicable here, with the reason: the reference's HLO pass (one
card, no XLA program: no collective or transpose to count),
``expected_grid`` (a CUDA wrapper sizes its grid from the card at run
time; the co-residency rule checks what a cooperative grid needs) and
``expected_aliases`` (the port's wrappers allocate their outputs; there
is no donation to declare), and ``interpret-flag`` (no interpret mode:
a CPU tensor takes the plain version).

Adding a kernel family: declare a ``CONTRACT`` dict in its module and a
fixture entry in :func:`build_registry`.  The checker CLI
(``python -m repro_torch.analysis.check``), the tests and
``chip_smoke.py``'s ``contracts`` phase all read this registry.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.analysis import trace_check
from repro_torch.kernels import build, ops, smem_budget

#: The kernel families the registry must cover.
FAMILIES = ("rrr_expand", "greedy_pick", "lazy_greedy", "bucket_insert",
            "cascade", "service", "topk_gain", "coverage", "bucket")

#: Attribute fields of :func:`device_kernels` (``kernel_attributes``).
ATTRIBUTES = ("static_smem", "registers", "local_bytes", "max_threads",
              "threads")


@dataclasses.dataclass(frozen=True)
class ShapePattern:
    """A tensor to require or forbid: exact dtype and shape."""
    dtype: str
    shape: tuple
    note: str = ""

    def describe(self) -> str:
        dims = ",".join(str(d) for d in self.shape)
        tail = f" ({self.note})" if self.note else ""
        return f"{self.dtype}[{dims}]{tail}"


@dataclasses.dataclass(frozen=True)
class Fixture:
    """A contract's canonical call on one device."""
    fn: Callable[[], Any]
    # launch name -> (W, x) of its shared memory (smem_budget.launch_bytes)
    shapes: Mapping[str, tuple] = dataclasses.field(default_factory=dict)
    # after fn ran: the steps of its loop (read by per-step contracts)
    steps: Optional[Callable[[], int]] = None
    # cooperative launch name -> blocks that must be resident at once
    coresident: Mapping[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    name: str                  # registry key, e.g. "rrr_expand.resident"
    family: str                # one of FAMILIES
    description: str
    build: Callable[[torch.device], Fixture]
    launches: Mapping[str, int]   # on the card, by kernel: a call's
    per_step: bool = False        # ... or each step's launches
    forbidden: tuple = ()
    required: tuple = ()
    dtype_whitelist: Optional[frozenset] = None
    local_memory: frozenset = frozenset()   # launches allowed local memory
    max_smem_bytes: Optional[int] = None    # None: the device's budget


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    message: str


@dataclasses.dataclass
class ContractReport:
    name: str
    family: str
    violations: list
    stats: dict

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_json(self) -> dict:
        return {
            "name": self.name, "family": self.family, "ok": self.ok,
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "stats": self.stats,
        }


# ------------------------------------------------------- the card's side
def _attributes(lib: str, i: int) -> dict:
    out = (ctypes.c_int64 * len(ATTRIBUTES))()
    err = build.function(lib, "kernel_attributes",
                         [ctypes.c_int, ctypes.c_void_p])(
                             i, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{lib}: CUDA error {err} reading the "
                           f"attributes of its kernel {i}")
    return dict(zip(ATTRIBUTES, out))


def device_kernels(device) -> dict[str, list]:
    """Every device function the libraries launch, by launch name, each
    with its library, table index, name and ``cudaFuncGetAttributes``
    (:data:`ATTRIBUTES`) on the CUDA ``device``."""
    out: dict[str, list] = {}
    with torch.cuda.device(device):
        for lib in build.LIBS:
            count = build.function(lib, "kernel_count", [])()
            text = [ctypes.c_int]
            for i in range(count):
                launch = build.function(lib, "kernel_launch", text,
                                        ctypes.c_char_p)(i).decode()
                name = build.function(lib, "kernel_name", text,
                                      ctypes.c_char_p)(i).decode()
                out.setdefault(launch, []).append(
                    dict(lib=lib, index=i, name=name,
                         **_attributes(lib, i)))
    return out


def c_launch_bytes(lib: str, kernel: str, num_words: int, x: int,
                   device) -> int:
    """The dynamic shared memory the C side of ``lib`` asks for when it
    launches ``kernel`` at (``num_words``, ``x``) (its ``launch_smem``)."""
    with torch.cuda.device(device):
        return int(build.function(
            lib, "launch_smem", [ctypes.c_char_p, ops.I64, ops.I64],
            ctypes.c_int64)(kernel.encode(), num_words, x))


def occupancy(entry: dict, smem: int, device) -> int:
    """Resident blocks an SM of the device function ``entry`` (from
    :func:`device_kernels`) at its block and ``smem`` dynamic bytes."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build.function(entry["lib"], "kernel_occupancy",
                             [ctypes.c_int, ops.I64, ctypes.c_void_p])(
                                 entry["index"], smem,
                                 ctypes.addressof(blocks))
    if err:
        raise RuntimeError(f"{entry['name']}: CUDA error {err} reading "
                           "its occupancy")
    return blocks.value


# ------------------------------------------------------------- checking
def run_contract(contract: KernelContract,
                 device="cuda") -> ContractReport:
    """Run the contract's fixture on ``device`` and prove every declared
    invariant (see the module's docstring for the rules on each
    device)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    fixture = contract.build(dev)
    before = dict(ops.LAUNCHES)
    _, rec = trace_check.record(fixture.fn)
    if on_card:
        torch.cuda.synchronize(dev)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.KERNELS
                if ops.LAUNCHES[k] != before[k]}
    steps = fixture.steps() if contract.per_step else None
    violations: list = []

    def bad(rule: str, message: str):
        violations.append(Violation(rule, message))

    # --- launch accounting -------------------------------------------
    per = steps if contract.per_step else 1
    want = ({k: c * per for k, c in contract.launches.items() if c * per}
            if on_card else {})
    if contract.per_step and not steps:
        bad("launch-count", "the call's loop ran no step, so its per-step "
            "launch counts would hold vacuously")
    if launched != want:
        bad("launch-count", f"expected launches {want} on {dev.type}, "
            f"ops.LAUNCHES counted {launched}")
    seen = trace_check.launch_counts(rec)
    if seen != launched:
        bad("launch-count", f"the recorder noted launches {seen}, "
            f"ops.LAUNCHES counted {launched}")

    # --- layout patterns ---------------------------------------------
    for pattern in contract.forbidden:
        if trace_check.has_intermediate(rec, pattern.dtype, pattern.shape):
            bad("forbidden-intermediate",
                f"forbidden tensor {pattern.describe()} was built")
    for pattern in contract.required:
        if not trace_check.has_intermediate(rec, pattern.dtype,
                                            pattern.shape):
            bad("missing-intermediate",
                f"required tensor {pattern.describe()} was not built — "
                "the forbidden pattern's twin would be vacuous")

    # --- dtype whitelist ---------------------------------------------
    dtypes = trace_check.dtypes_used(rec)
    if contract.dtype_whitelist is not None:
        extra = dtypes - set(contract.dtype_whitelist)
        if extra:
            bad("dtype-whitelist",
                f"the call built dtypes {sorted(extra)} outside the "
                f"whitelist {sorted(contract.dtype_whitelist)}")

    # --- shared memory -----------------------------------------------
    budget = (contract.max_smem_bytes if contract.max_smem_bytes is not None
              else smem_budget.budget_bytes(dev))
    table = device_kernels(dev) if on_card else {}
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if on_card else 0)
    footprint = {}
    for kernel in sorted(k for k, c in contract.launches.items() if c):
        if kernel not in fixture.shapes:
            bad("smem-footprint", f"{kernel}: the fixture declares no "
                "shape for its shared memory")
            continue
        w, x = fixture.shapes[kernel]
        dyn = smem_budget.launch_bytes(kernel, w, x)
        static = smem_budget.STATIC_BYTES[kernel]
        if on_card:
            entries = table[kernel]
            card_static = max(e["static_smem"] for e in entries)
            c_dyn = c_launch_bytes(entries[0]["lib"], kernel, w, x, dev)
            if (c_dyn, card_static) != (dyn, static):
                bad("smem-model", f"{kernel} at W={w}, x={x}: the model "
                    f"gives {dyn} dynamic + {static} static bytes, the "
                    f"card {c_dyn} + {card_static}")
            static = card_static
            for e in entries:
                if e["local_bytes"] and kernel not in contract.local_memory:
                    bad("local-memory", f"{e['name']} keeps "
                        f"{e['local_bytes']} bytes of local memory a "
                        "thread (stack frame or spills), which the "
                        "contract does not allow")
            need = fixture.coresident.get(kernel)
            if need:
                held = min(occupancy(e, dyn, dev) for e in entries) * sms
                if held < need:
                    bad("co-residency", f"{kernel}: {need} blocks must be "
                        f"resident at once, the card holds {held}")
        footprint[kernel] = dict(dynamic=dyn, static=static)
        if dyn + static > budget:
            bad("smem-footprint", f"{kernel} at W={w}, x={x} asks for "
                f"{dyn} dynamic + {static} static bytes of shared "
                f"memory, over the budget of {budget}")

    stats = {
        "device": dev.type,
        "launches": launched,
        "steps": steps,
        "ops": len(rec.ops),
        "dtypes": sorted(dtypes),
        "smem": footprint,
        "smem_budget_bytes": budget,
    }
    return ContractReport(contract.name, contract.family, violations, stats)


# ------------------------------------------------------------- fixtures
def _graph(device: torch.device):
    """The reference's canonical sampler graph (ER n = 48, avg degree 4,
    seed 0) and its padded tables: its forward width differs from the
    coin plane's, so the mask patterns cannot match by accident.  Built
    for each fixture (a few kilobytes), so no run keeps it on the card."""
    from repro_torch.graphs import csr, generators
    g = generators.erdos_renyi(48, 4.0, seed=0, device=device)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    return g, nbr, prob, wt, fwd


def mask_shape() -> tuple:
    """[n, d_out, W] of the sampler fixture's gathered mask (theta 64)."""
    from repro_torch.core import rrr
    g, nbr, _, _, fwd = _graph(torch.device("cpu"))
    df = int(fwd[0].shape[1])
    d_pad = rrr._coin_chunks(int(nbr.shape[1]), 32)[2]
    assert df not in (d_pad, 0), (df, d_pad)
    return g.num_vertices, df, 2


def _sampler(gather: str, model: str = "IC"):
    """The kernel sampler on the fixture graph, fed only the tables its
    path reads (``rrr.graph_tables``: the LT push its CSR tables)."""
    def build_(device):
        from repro_torch.core import prng, rrr
        g = _graph(device)[0]
        nbr, prob, wt, fwd, lt = rrr.graph_tables(g, "kernel", gather, model)
        stats: dict = {}
        return Fixture(
            fn=lambda: rrr.sample_incidence(
                nbr, prob, wt, prng.key(0), theta=64, n=g.num_vertices,
                model=model, max_steps=6, sampler="kernel", gather=gather,
                fwd=fwd, stats=stats, lt=lt),
            shapes={k: (2, 0) for k in ("rrr_expand_ic", "rrr_expand_lt",
                                        "coin_pack", "rrr_expand_streamed")},
            steps=lambda: stats["bfs_steps"])
    return build_


def rows_fixture(device) -> torch.Tensor:
    """The reference's canonical row pool: uint32 [64, 4] from
    ``np.random.default_rng(0)``, as int32 bit patterns."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, (64, 4), dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _maxcover(solver: str, k: int = 8):
    def build_(device):
        from repro_torch.core import maxcover
        rows = rows_fixture(device)
        w = rows.shape[1]
        return Fixture(
            fn=lambda: maxcover.greedy_maxcover(rows, k, solver=solver),
            shapes={"compact_rows": (w, 0), "greedy_pick_compact": (w, 0),
                    "lazy_greedy_compact": (w, 0), "topk_gain": (w, 0)},
            steps=lambda: k)
    return build_


def _dense(solver: str, k: int = 8):
    """A solve forced onto the dense layout (the fixture's rows would take
    the compact one), which hands over to the compact picks once its
    residual fits the layout's room, after its first pick here."""
    def build_(device):
        from repro_torch.kernels import greedy_pick, lazy_greedy
        rows = rows_fixture(device)[None]
        w = rows.shape[2]
        ex = greedy_pick.excluded_ids(None, 1, device)
        solve = (greedy_pick.greedy_dense if solver == "resident"
                 else lazy_greedy.lazy_dense)
        return Fixture(
            fn=lambda: solve(rows, k, ex),
            shapes={n: (w, 0) for n in (
                "greedy_pick", "lazy_greedy", "compact_rows",
                "greedy_pick_compact", "lazy_greedy_compact")},
            coresident={"greedy_pick": 1, "lazy_greedy": 1})
    return build_


def _batch(solver: str, batch: int = 4, k: int = 6):
    def build_(device):
        from repro_torch.core import maxcover
        rows = rows_fixture(device)
        w = rows.shape[1]
        excl = torch.full((batch, 3), -1, dtype=torch.int32, device=device)
        return Fixture(
            fn=lambda: maxcover.greedy_maxcover_batch(rows, excl, k,
                                                      solver=solver),
            shapes={n: (w, batch) for n in (
                "greedy_pick_batch", "lazy_greedy_batch", "topk_gain_batch")},
            steps=lambda: k,
            coresident={"greedy_pick_batch": 1, "lazy_greedy_batch": 1})
    return build_


def _ripples(k: int = 8, m: int = 2):
    def build_(device):
        from repro_torch.core import randgreedi
        rows = rows_fixture(device)
        n, w = rows.shape
        x = rows.reshape(n, m, w // m).permute(1, 0, 2).contiguous()
        return Fixture(
            fn=lambda: randgreedi.ripples_picks(x, k, use_kernel=True),
            shapes={"coverage": (w // m, 0)}, steps=lambda: k)
    return build_


def _bucket(kind: str):
    def build_(device):
        from repro_torch.core import streaming
        state = streaming.init_state(5, 0.077, 10.0, 11, device=device)
        if kind == "chunk":
            ids = torch.zeros((4,), dtype=torch.int32, device=device)
            rows = torch.zeros((4, 11), dtype=torch.int32, device=device)
            fn = lambda: streaming.insert_chunk(  # noqa: E731
                state, ids, rows, k=5, use_kernel=True)
        else:
            ids = torch.zeros((3, 4), dtype=torch.int32, device=device)
            rows = torch.zeros((3, 4, 11), dtype=torch.int32, device=device)
            fn = lambda: streaming.insert_stream(  # noqa: E731
                state, ids, rows, k=5, use_kernel=kind == "stream")
        # W = 11 is not a multiple of 4: the receiver takes 4-byte units
        return Fixture(fn=fn, shapes={"bucket_insert": (11, 0),
                                      "bucket_insert_stream": (11, 0)})
    return build_


def _gains(device):
    from repro_torch.kernels import bucket
    rows = rows_fixture(device)
    row, covers = rows[0], rows[1:6].contiguous()
    return Fixture(fn=lambda: bucket.bucket_gains(row, covers),
                   shapes={"bucket_gains": (rows.shape[1], 0)})


def _cascade(model: str = "IC", gather: str = "auto", num_sims: int = 32):
    def build_(device):
        from repro_torch.core import cascade, prng, rrr
        g, nbr, _, _, _ = _graph(device)
        seeds = np.array([0, 1])
        n_chunks = rrr._coin_chunks(int(nbr.shape[1]), 32)[1]
        spans = []

        def clock(name):
            spans.append(name)
            return contextlib.nullcontext()

        def run():
            # the loop's steps, counted through the cascade's measurement
            # hook (one ``step`` span a step)
            old, cascade._clock = cascade._clock, clock
            try:
                return cascade.simulate_cascades(
                    g, seeds, prng.key(0), model=model, num_sims=num_sims,
                    max_steps=4, engine="kernel", gather=gather)
            finally:
                cascade._clock = old

        words = -(-num_sims // 32)
        return Fixture(
            fn=run,
            shapes={"cascade_ic": (words, 2 * n_chunks * num_sims),
                    "cascade_lt": (words, 2 * num_sims),
                    "rrr_expand_resident": (words, 0)},
            steps=lambda: spans.count("step"))
    return build_


# ------------------------------------------------------------- registry
def _declared(module_contract: dict, key: Optional[str] = None) -> dict:
    """One family's declaration (modules with several variants nest them
    under ``variants``)."""
    decl = dict(module_contract)
    variants = decl.pop("variants", None)
    if key is not None:
        decl.update(variants[key])
    return decl


def _contract(name: str, description: str, decl: dict, build_, **extra):
    return KernelContract(
        name=name, family=decl["family"], description=description,
        build=build_, launches=decl["launches"],
        per_step=decl.get("per_step", False),
        dtype_whitelist=frozenset(decl["dtypes"]),
        local_memory=frozenset(decl.get("local_memory", ())), **extra)


def build_registry() -> tuple:
    """Every registered contract: the reference's ten names and those
    that reach the port's other launch names, so that every name of
    ``ops.KERNELS`` is launched by some contract."""
    from repro_torch.core import cascade as cascade_mod
    from repro_torch.core import service as service_mod
    from repro_torch.kernels import bucket as bucket_mod
    from repro_torch.kernels import bucket_insert as insert_mod
    from repro_torch.kernels import coverage as coverage_mod
    from repro_torch.kernels import greedy_pick as greedy_mod
    from repro_torch.kernels import lazy_greedy as lazy_mod
    from repro_torch.kernels import rrr_expand as rrr_mod
    from repro_torch.kernels import topk_gain as topk_mod

    gmask = ShapePattern("int32", mask_shape(),
                         "the gathered [n, d_out, W] mask")

    def decl(module, key):
        return _declared(module.CONTRACT, key)

    return (
        _contract("rrr_expand.resident",
                  "kernel sampler, resident layout: one push a BFS step "
                  "(rrr_expand_ic), coins drawn in it, no gathered mask",
                  decl(rrr_mod, "resident"), _sampler("resident"),
                  forbidden=(gmask,)),
        _contract("rrr_expand.streamed",
                  "kernel sampler, streamed layout: the coin plane "
                  "(coin_pack) gathered in one pass and expanded "
                  "(rrr_expand_streamed) each step; the mask exists here "
                  "(keeps the resident twin non-vacuous)",
                  decl(rrr_mod, "streamed"), _sampler("streamed"),
                  required=(gmask,)),
        _contract("rrr_expand.lt",
                  "kernel sampler under LT: one push a BFS step "
                  "(rrr_expand_lt), the live in-edge drawn in it",
                  decl(rrr_mod, "lt"), _sampler("resident", "LT"),
                  forbidden=(gmask,)),
        _contract("greedy_pick.resident",
                  "resident sender: the rows listed once (compact_rows), "
                  "then all k picks in one launch over the list",
                  decl(greedy_mod, "resident"), _maxcover("resident")),
        _contract("greedy_pick.scan_ref",
                  "scan reference path: plain PyTorch, no launch",
                  decl(greedy_mod, "scan_ref"), _maxcover("scan")),
        _contract("greedy_pick.dense",
                  "dense sweep (greedy_pick) handing over to the compact "
                  "picks over its residual's list",
                  decl(greedy_mod, "dense"), _dense("resident")),
        _contract("lazy_greedy.resident",
                  "lazy sender: the list, then one launch with stale-bound "
                  "tile skipping inside", decl(lazy_mod, "resident"),
                  _maxcover("lazy")),
        _contract("lazy_greedy.dense",
                  "lazy dense sweep (lazy_greedy) handing over with its "
                  "tile bounds", decl(lazy_mod, "dense"), _dense("lazy")),
        _contract("lazy_greedy.batch",
                  "lazy query axis: B queries over one pool in one launch",
                  decl(lazy_mod, "batch"), _batch("lazy")),
        _contract("topk_gain.fused",
                  "fused solver: one gain sweep and argmax launch a pick",
                  decl(topk_mod, "fused"), _maxcover("fused")),
        _contract("topk_gain.batch",
                  "fused query axis: one launch a pick for all B queries",
                  decl(topk_mod, "batch"), _batch("fused")),
        _contract("coverage.ripples",
                  "Ripples picks: one marginal-gain sweep a pick",
                  decl(coverage_mod, "ripples"), _ripples()),
        _contract("bucket_insert.chunk",
                  "fused-chunk receiver: one launch a chunk",
                  decl(insert_mod, "chunk"), _bucket("chunk")),
        _contract("bucket_insert.stream",
                  "pipelined receiver: ONE launch for the whole [R, C, W] "
                  "candidate stream", decl(insert_mod, "stream"),
                  _bucket("stream")),
        _contract("bucket_insert.scan_ref",
                  "scan receiver: plain PyTorch, no launch",
                  decl(insert_mod, "scan_ref"), _bucket("scan")),
        _contract("bucket.gains",
                  "one row's gains against B bucket covers in one launch",
                  decl(bucket_mod, "gains"), _gains),
        _contract("cascade.kernel",
                  "cascade kernel engine: one launch a diffusion step "
                  "(cascade_ic), live edges drawn in it",
                  decl(cascade_mod, "kernel"), _cascade("IC")),
        _contract("cascade.lt",
                  "cascade kernel engine under LT: one launch a step "
                  "(cascade_lt)", decl(cascade_mod, "lt"), _cascade("LT")),
        _contract("cascade.resident",
                  "cascade over the live-edge plane, resident gather: one "
                  "rrr_expand_resident launch a step",
                  decl(cascade_mod, "resident"),
                  _cascade("IC", "resident")),
        _contract("service.batched",
                  "batched query solve: B concurrent seed-constrained "
                  "queries in ONE launch", decl(service_mod, "batched"),
                  _batch("resident")),
    )


def contracts_by_name() -> dict:
    return {c.name: c for c in build_registry()}
