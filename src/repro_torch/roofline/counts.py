"""What one rank's step runs, counted op by op: the port's counterpart of
``repro/roofline/hlo_analysis.py``.

The reference parses the compiled, SPMD-partitioned HLO of a step.  The
port has no HLO: it runs eagerly, so ``OpCounts`` (a ``TorchDispatchMode``)
records every aten and c10d op that one rank's step dispatches, on real
tensors or on the meta device (the dry run, where nothing is computed).

Accounting (per rank = per card):
  * FLOPs: ``torch.utils.flop_counter``'s formulas for aten ops (matmuls,
    convolutions, attention ops; elementwise ops count 0, as the
    reference counts only dots).
  * Bytes: operand plus result bytes of every aten op (an in-place op
    counts its destination both as operand and as result).  Views, and
    allocations that write nothing (``empty`` and its kin), count 0.  The
    port runs eagerly and unfused, so this is the HBM traffic of the step
    on the card, give or take L2 hits; the reference's figure is a proxy
    after XLA's fusion (fusion internals stay in registers there).
  * Collectives: every c10d op, by kind, with the ring multipliers of
    ``analysis.ring_bytes`` on its result over its group's size, and the
    link it crosses (``analysis.spans_nodes`` on the group's global
    ranks).  An all-to-all with explicit split sizes is the point-to-point
    exchange of ``dist/collectives.py:_exchange`` (under
    ``regroup_halves``).
  * The hand-written kernels: neither the flop counter nor a dispatch mode
    sees a ctypes launch, so each entry point counts its kernel by formula
    (``kernel_call``) with the ops inside it not recorded: on the card, on
    the CPU (its plain version) and on meta alike.  The formulas are
    ``flash_work``, ``frontier_work`` and ``distance_work``, which
    ``chip_smoke.py``'s bounds use too.
  * Per-token loops: the reference multiplies a ``while`` body by its trip
    count.  Here a loop asks ``loop_steps(n)`` how many of its n steps to
    run; under an ``OpCounts(loop_steps=m)`` it runs m and pads its output
    (``pad_steps``, meta only).  The counts are affine in m for m >= 2, so
    ``extrapolate`` takes two traces (m and m + 1) to the count of n steps.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

from repro_torch.roofline import analysis as RA

_aten = torch.ops.aten
# ops that move no bytes: allocations that write nothing, and the
# reshapes that alias their input without a view annotation
_FREE = {_aten.empty.memory_format, _aten.empty_like.default, _aten.new_empty.default,
         _aten.empty_strided.default, _aten.new_empty_strided.default,
         _aten._unsafe_view.default, _aten.lift_fresh.default}
_COLLECTIVES = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
                "_allgather_base_": "all-gather", "allgather_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
                "reduce_scatter_tensor_coalesced_": "reduce-scatter",
                "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
                "broadcast_": "broadcast"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@functools.cache
def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


class OpCounts(TorchDispatchMode):
    """The counts of everything dispatched while it is entered: ``flops``,
    ``bytes``, ``collectives`` (bytes moved by kind), ``collective_counts``,
    ``by_link`` (bytes moved over NVLink and over the network), ``kernels``
    (by entry point: calls, flops, bytes) and ``ops`` (by aten op: calls,
    flops, bytes; ``top_contributors``).  ``loop_steps``: run that many
    steps of each per-token loop (``loop_steps()``); the trip counts
    truncated are kept in ``trips``."""

    def __init__(self, *, loop_steps: int | None = None):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict = {}
        self.collective_counts: dict = {}
        self.by_link = {"nvlink": 0.0, "network": 0.0}
        self.kernels: dict = {}
        self.ops: dict = {}
        self.loop_steps = loop_steps
        self.trips: set = set()
        self._paused = 0
        self._links: dict = {}

    # -- recording ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
        flops = 0.0
        reg = _flop_registry()
        if func.overloadpacket in reg:
            flops = float(reg[func.overloadpacket](*args, **kwargs, out_val=out))
        nbytes = 0.0 if func.is_view or func in _FREE else float(
            _nbytes((args, kwargs)) + _nbytes(out))
        self._add(str(func.overloadpacket), flops, nbytes)

    def _add(self, name: str, flops: float, nbytes: float, calls: int = 1):
        self.flops += flops
        self.bytes += nbytes
        row = self.ops.setdefault(name, [0, 0.0, 0.0])
        row[0] += calls
        row[1] += flops
        row[2] += nbytes

    def _link(self, pg) -> str:
        """'network' if the group spans nodes, else 'nvlink' (cached by
        group)."""
        import torch.distributed as dist
        key = id(pg)
        if key not in self._links:
            ranks = dist.get_process_group_ranks(pg)
            self._links[key] = (pg, "network" if RA.spans_nodes(ranks) else "nvlink")
        return self._links[key][1]

    def _collective(self, func, args, kwargs):
        import torch.distributed as dist
        base = func.name().split("::", 1)[1]
        kind = _COLLECTIVES.get(base, base)
        bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
        pg = dist.ProcessGroup.unbox(bound["process_group"])
        n = pg.size()
        if kind == "all-to-all" and base == "alltoall_base_" and (
                bound.get("output_split_sizes") or bound.get("input_split_sizes")):
            kind = "exchange"
        # the first argument is the result: the tensors reduced or sent in
        # place, or the output buffers
        moved = RA.ring_bytes(kind, _nbytes(args[0]), n) if kind in RA.RING_FACTOR else 0.0
        self.collectives[kind] = self.collectives.get(kind, 0.0) + moved
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1
        if moved:
            self.by_link[self._link(pg)] += moved

    @contextlib.contextmanager
    def paused(self):
        """Nothing dispatched inside the block is recorded."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self._add(f"kernel:{name}", flops, nbytes)

    # -- results ----------------------------------------------------------
    def totals(self) -> dict:
        """The reference's ``analyse_hlo`` keys: flops, bytes, collectives
        (bytes by kind), collective_counts, collective_bytes, and the
        port's by_link, kernels and n_ops."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "collective_counts": dict(self.collective_counts),
                "collective_bytes": float(sum(self.collectives.values())),
                "by_link": dict(self.by_link),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "n_ops": sum(r[0] for r in self.ops.values())}


def active() -> OpCounts | None:
    """The innermost ``OpCounts`` entered, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounts):
            return mode
    return None


def kernel_call(name: str, work):
    """Decorate a kernel's entry point: while an ``OpCounts`` is entered,
    the ops it runs are not recorded and its kernel counts
    ``work(out, *args, **kwargs)`` -> (flops, bytes) instead (computed
    with recording paused)."""
    def wrap(fn):
        def entry(*args, **kwargs):
            rec = active()
            if rec is None:
                return fn(*args, **kwargs)
            with rec.paused():
                out = fn(*args, **kwargs)
                flops, nbytes = work(out, *args, **kwargs)
            rec.add_kernel(name, flops, nbytes)
            return out
        entry.__name__, entry.__doc__ = fn.__name__, fn.__doc__
        entry.__wrapped__ = fn
        return entry
    return wrap


# ---------------------------------------------------------------------------
# per-token loops
# ---------------------------------------------------------------------------
def loop_steps(n: int) -> int:
    """How many of a per-token loop's ``n`` steps to run: ``n``, unless an
    ``OpCounts`` with ``loop_steps`` is entered (it then notes ``n``)."""
    rec = active()
    if rec is None or rec.loop_steps is None or n <= rec.loop_steps:
        return n
    rec.trips.add(n)
    return rec.loop_steps


def _unrecorded():
    rec = active()
    return rec.paused() if rec is not None else contextlib.nullcontext()


class _PadSteps(torch.autograd.Function):
    """Stands in for the steps not run: neither way is recorded."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.m = dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n
        with _unrecorded():
            return x.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        with _unrecorded():
            return g.narrow(ctx.dim, 0, ctx.m), None, None


def pad_steps(x: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    """A loop's stacked output of m < n steps, as if it had run all ``n``
    (meta tensors only: the values are not there)."""
    if x.device.type != "meta":
        raise ValueError("a per-token loop runs all its steps on real tensors")
    return _PadSteps.apply(x, dim, n)


def extrapolate(lo: dict, hi: dict, m: int, n: int) -> dict:
    """The totals (or the ``ops`` table) of a step whose loops ran ``n``
    steps, from those with ``m`` (``lo``) and ``m + 1`` (``hi``) steps:
    every count is affine in the steps for m >= 2."""
    def ext(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            a, b = a or {}, b or {}
            return {k: ext(a.get(k), b.get(k)) for k in sorted(set(a) | set(b))}
        if isinstance(a, list) or isinstance(b, list):
            a, b = a or [0] * len(b), b or [0] * len(a)
            return [ext(x, y) for x, y in zip(a, b)]
        a, b = a or 0, b or 0
        return a + (n - m) * (b - a)
    return ext(lo, hi)


# ---------------------------------------------------------------------------
# the hand-written kernels' work, by formula
# ---------------------------------------------------------------------------
def flash_work(b: int, h: int, hk: int, sq: int, sk: int, d: int, causal: bool,
               itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one flash forward: 4 d operations per visible
    (query, key) pair and head (bottom-right causal), q, k and v read and
    the output written once."""
    if causal:
        off = sk - sq
        # sum over query i of clip(i + off + 1, 0, sk)
        lo = max(0, -off)                      # first query that sees a key
        full = max(lo, min(sq, sk - off))      # queries before this see < sk keys
        pairs = sum(range(lo + off + 1, full + off + 1)) + (sq - full) * sk
    else:
        pairs = sq * sk
    nops = 4.0 * b * h * d * pairs
    nbytes = float((2 * b * h * sq * d + 2 * b * hk * sk * d) * itemsize)
    return nops, nbytes


def frontier_work(fids, queries, outs, cap: int, prune: bool) -> tuple[float, float]:
    """(operations, bytes) of one frontier scoring on this data (``outs``:
    the kernel's four outputs): each referenced page's radius/validity
    (+pdist) rows and each live entry's vector read once, the four outputs
    written once; 3 operations per dimension of a live entry and 4 per
    output slot.  On meta (no data) every entry is live and every page
    distinct."""
    b, F = fids.shape
    dim = queries.shape[1]
    if fids.device.type == "meta":
        n_live = n_vec_rows = b * F * cap
        n_pages = b * F
    else:
        live = torch.isfinite(outs[0]) | torch.isfinite(outs[2])
        n_live = int(live.sum())
        nodes = fids.clamp(min=0).long()
        entry = nodes[:, :, None] * cap + torch.arange(cap, device=fids.device)
        n_vec_rows = torch.unique(entry[live]).numel()
        n_pages = torch.unique(nodes[fids >= 0]).numel()
    per_page = cap * (4 + 1 + 1 + (4 if prune else 0))
    nbytes = (fids.numel() * 4 + queries.numel() * 4
              + n_pages * per_page + n_vec_rows * dim * 4
              + (b * F * 4 + b * 4 if prune else 0)
              + 4 * b * F * cap * 4)
    return float(n_live * dim * 3 + 4 * b * F * cap), float(nbytes)


def distance_work(nq: int, ne: int, d: int, prune: bool) -> tuple[float, float]:
    """(operations, bytes) of one distance scan: 3 operations per pair and
    dimension; the inputs read and the distances (and, pruned, the radii
    and the mask) written once."""
    if prune:
        return float(nq * ne * d * 3), float((nq * d + ne * d + nq + ne) * 4 + nq * ne * 5)
    return float(nq * ne * d * 3), float((nq * d + ne * d + nq * ne) * 4)


def top_contributors(ops: dict, n: int = 8) -> list[dict]:
    """The ops with the most FLOPs and the most bytes (``ops``: an
    ``OpCounts.ops`` table, {op: [calls, flops, bytes]}): the ``n`` rows of
    each ranking, merged, by op name (``kernel:<name>`` for a kernel)."""
    rows = [{"op": k, "calls": c, "flops": f, "bytes": b} for k, (c, f, b) in ops.items()]
    keep = {r["op"] for key in ("flops", "bytes")
            for r in sorted(rows, key=lambda r: -r[key])[:n]}
    return sorted((r for r in rows if r["op"] in keep), key=lambda r: -(r["flops"] + r["bytes"]))
