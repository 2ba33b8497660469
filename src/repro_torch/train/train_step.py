"""The training step (port of ``repro/train/train_step.py``): loss, grad,
the optional int8 compression (with error feedback), AdamW, with
activation checkpoints by period of the block pattern.

``make_train_step(cfg, settings=settings)`` (no mesh) returns
``step_fn(params, opt, batch) -> (params, opt, metrics)`` or, with int8
compression and error feedback, ``step_fn_ef(params, opt, ef, batch) ->
(params, opt, ef, metrics)``.  ``make_train_step(cfg, mesh, inputs_spec,
settings)`` is the mesh form (below).
``params`` is the model (``init_all`` makes its parameters require grad);
the step writes it and the optimizer's moments in place.  The metrics are
the reference's: ``loss``, the aux keys, ``grad_norm``, ``lr`` and
``total_loss``, as scalars on the model's device (the step waits for
nothing).  The int8 hook gives each stacked leaf of the reference's tree
one scale, over the per-layer parameters it stands for, so its numerics are
the reference's.

The mesh form runs on every rank of a {data, model} ``DeviceMesh``
(``launch/mesh.py:make_host_mesh``) and returns ``(step_fn, shardings)``
as the reference's does.  ``params`` is a ``dist.parallel.ShardedLM`` (this
rank's shards of the table's specs; ``init_sharded`` makes one), ``opt``
an ``AdamWState`` of this rank's ZeRO-1 moments (``opt_state_pspec``; a
layer whose moment the table puts on another data rank has none here),
``batch`` the global batch, of which the step takes this rank's rows
(``input_pspecs``).  The step: the sharded forward and backward
(``ShardedLM``; Megatron sequence parallelism with
``settings.seq_parallel``), the gradients summed over 'data' (an
all-reduce, or FSDP's reduce-scatter in the backward) and divided by its
size, the int8 hook with each scale's amax shared over the ranks
(``compressed_mean_hook(group=)``), the global norm from each gradient's
owning rank, AdamW on the local shards, then each ZeRO-1 slice all-gathered
(or a period-owned layer broadcast) back over 'data'.  The metrics are the
means over 'data'.  At world size 1 it is the one-device step, bitwise.

While torch.profiler runs, a step opens ``train.forward``,
``train.backward`` and ``train.optimizer`` ranges and waits for the card
at the end of each, so a profile splits the step's device time by phase.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.compression import compressed_mean_hook, init_ef_state
from repro_torch.models import model as M
from repro_torch.models.convert import path_str, reference_layout
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, _decay_mask, adamw_update,
                                         init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    opt: AdamWConfig = AdamWConfig()
    remat: bool = True
    moe_aux_weight: float = 0.01
    z_loss_weight: float = 1e-3
    grad_compression: str = "none"     # none | int8
    error_feedback: bool = False       # persistent EF state for int8 grads
    seq_parallel: bool = False         # Megatron SP on the residual stream


@contextlib.contextmanager
def _phase(name: str, device: torch.device):
    """A ``train.<name>`` range that waits for the card at its end, while
    a profiler runs; nothing otherwise."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(f"train.{name}"):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def loss_and_aux(params, cfg: ArchConfig, batch: dict, settings: TrainSettings, *,
                 _attention=None):
    """-> (total loss, {loss, aux keys}): the cross-entropy plus, with MoE
    layers, the weighted load-balance and z losses."""
    logits, aux = M.forward(params, cfg, batch, remat=settings.remat, _attention=_attention)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    loss = M.loss_fn(logits, labels, mask)
    total = loss
    if cfg.n_experts:
        total = total + settings.moe_aux_weight * aux["lb_loss"] \
            + settings.z_loss_weight * aux["z_loss"]
    return total, {"loss": loss, **aux}


def loss_and_grads(params, cfg: ArchConfig, batch: dict,
                   settings: TrainSettings = TrainSettings(), *, _attention=None):
    """The forward and backward of one step, no update: -> (total loss,
    metrics, {parameter name: gradient}).  A parameter that the loss does
    not reach gets a zero gradient, as under ``jax.grad``."""
    names, leaves = zip(*params.named_parameters())
    dev = leaves[0].device
    with _phase("forward", dev):
        total, metrics = loss_and_aux(params, cfg, batch, settings, _attention=_attention)
    with _phase("backward", dev):
        grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, dict(zip(names, grads))


def _decay_and_groups(params, cfg: ArchConfig) -> tuple[dict, list]:
    """{name: decays?} and the names grouped by the reference's leaf (the
    periods of one stacked leaf, in period order)."""
    layout = reference_layout(params, cfg)
    groups: dict = {}
    for name, (path, _) in layout.items():
        groups.setdefault(path, []).append(name)
    return ({name: _decay_mask(path_str(path)) for name, (path, _) in layout.items()},
            list(groups.values()))


def make_train_step(cfg: ArchConfig, mesh=None, inputs_spec: dict | None = None,
                    settings: TrainSettings = TrainSettings(), *, _attention=None):
    """-> ``step_fn`` (or ``step_fn_ef``, with int8 compression and error
    feedback; start it from ``init_all(..., error_feedback=True)``); with a
    ``mesh``, (that function, shardings) for this rank (``inputs_spec``:
    the batch's tensors or anything with their shapes).  ``_attention``
    (private) replaces the attention entry point, so the card can run the
    plain version and compare."""
    if mesh is not None:
        return _make_sharded_step(cfg, mesh, inputs_spec, settings, _attention)
    use_ef = settings.error_feedback and settings.grad_compression == "int8"
    layout: list = []           # (decay, groups): they depend on cfg alone

    def update(params, opt, grads, ef=None):
        if not layout:
            layout.extend(_decay_and_groups(params, cfg))
        decay, groups = layout
        if settings.grad_compression == "int8":
            grads = compressed_mean_hook(grads, groups=groups, ef=ef)
            if ef is not None:
                grads, ef = grads
        _, opt, opt_metrics = adamw_update(settings.opt, dict(params.named_parameters()),
                                           grads, opt, decay)
        return opt, ef, opt_metrics

    def step_fn(params, opt, batch):
        total, metrics, grads = loss_and_grads(params, cfg, batch, settings,
                                               _attention=_attention)
        with _phase("optimizer", total.device):
            opt, _, opt_metrics = update(params, opt, grads)
        return params, opt, {**metrics, **opt_metrics, "total_loss": total}

    def step_fn_ef(params, opt, ef, batch):
        total, metrics, grads = loss_and_grads(params, cfg, batch, settings,
                                               _attention=_attention)
        with _phase("optimizer", total.device):
            opt, ef, opt_metrics = update(params, opt, grads, ef)
        return params, opt, ef, {**metrics, **opt_metrics, "total_loss": total}

    return step_fn_ef if use_ef else step_fn


def init_all(cfg: ArchConfig, seed: int = 0, *, device=None, error_feedback: bool = False):
    """Seeded weights that require grad, and a zero optimizer state (and,
    with ``error_feedback``, zero residuals keyed by parameter name)."""
    params = M.trainable(M.init_params(cfg, seed, device=device))
    opt = init_opt_state(params)
    if error_feedback:
        return params, opt, init_ef_state(
            {k: p.detach() for k, p in params.named_parameters()})
    return params, opt


# ---------------------------------------------------------------------------
# the mesh form
# ---------------------------------------------------------------------------
def _owns(spec, coords: dict) -> bool:
    """Whether this rank's copy of a leaf counts in the global norm: the
    first of its replicas over every axis its spec does not split."""
    from repro_torch.dist.sharding import _used_axes
    used = _used_axes(spec)
    return all(c == 0 for a, c in coords.items() if a not in used)


def _zero_slice(pspec, mspec):
    """The dim on which ZeRO-1 splits a moment and not its parameter."""
    from repro_torch.dist.sharding import _axes_of
    return next((d for d, (p, m) in enumerate(zip(pspec, mspec))
                 if "data" in _axes_of(m) and "data" not in _axes_of(p)), None)


def moment_layout(cfg: ArchConfig, mesh) -> dict:
    """{parameter name: (its moments' spec, the data rank that holds its
    layer's moments or None, the dim ZeRO-1 splits or None)}."""
    from repro_torch.dist import sharding as shd
    meta = M.param_specs(cfg)
    pspecs = shd.layer_specs(cfg, meta, mesh)
    out = {}
    for name, (mspec, owner) in shd.layer_specs(cfg, meta, mesh, opt=True).items():
        # ZeRO-1 adds only 'data', so an owned layer is owned along 'data'
        out[name] = (mspec, None if owner is None else owner[1],
                     None if owner else _zero_slice(pspecs[name], mspec))
    return out


def _holds(moment, coords: dict) -> bool:
    return moment[1] is None or coords["data"] == moment[1]


def init_sharded_opt(params, cfg: ArchConfig, mesh) -> AdamWState:
    """Zero ZeRO-1 moments of this rank (``opt_state_pspec``'s slices of
    each parameter; none for a layer another data rank holds)."""
    from repro_torch.dist import sharding as shd
    dev = params.params["embed"].device
    moments = {}
    coords = shd.mesh_coords(mesh)
    for name, moment in moment_layout(cfg, mesh).items():
        mspec = moment[0]
        if _holds(moment, coords):
            sl = shd.local_slices(mspec, params.shapes[name], mesh)
            moments[name] = tuple(x.stop - x.start for x in sl)
    zeros = lambda: {k: torch.zeros(v, dtype=torch.float32, device=dev)
                     for k, v in moments.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())


def init_sharded(cfg: ArchConfig, mesh, seed: int = 0, *, device=None,
                 error_feedback: bool = False):
    """``init_all``'s state on this rank: the seeded full model, cut to
    this rank's shards (``ShardedLM``), its ZeRO-1 moments (and zero
    residuals shaped like its shards)."""
    from repro_torch.dist.parallel import ShardedLM
    model = M.init_params(cfg, seed, device=device)
    params = ShardedLM.from_model(model, cfg, mesh, requires_grad=True)
    del model
    opt = init_sharded_opt(params, cfg, mesh)
    if error_feedback:
        return params, opt, init_ef_state({k: p.detach() for k, p in params.named_parameters()})
    return params, opt


def _make_sharded_step(cfg: ArchConfig, mesh, inputs_spec, settings: TrainSettings,
                       _attention):
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import all_reduce, all_reduce_
    from repro_torch.dist.parallel import Ranks

    r = Ranks.of(mesh)
    coords = shd.mesh_coords(mesh)
    use_ef = settings.error_feedback and settings.grad_compression == "int8"
    meta = M.param_specs(cfg)
    pspecs = shd.param_pspecs(cfg, meta, mesh)
    shapes = shd.reference_shapes(meta, cfg)
    opt_specs = shd._map_specs(lambda s, t: shd.opt_state_pspec(s, t.shape, mesh),
                               pspecs, shapes)
    in_specs = shd.input_pspecs(cfg, "train", inputs_spec, mesh)
    shardings = dict(params=pspecs, opt={"step": shd.Spec(), "mu": opt_specs, "nu": opt_specs},
                     batch=in_specs, metrics=shd.Spec(), pspecs=pspecs)
    if use_ef:
        shardings["ef"] = pspecs
    rows_split = in_specs["tokens"][0] is not None
    layer = shd.layer_specs(cfg, meta, mesh)
    moments = moment_layout(cfg, mesh)
    decay, groups = _decay_and_groups(meta, cfg)
    world = dist.group.WORLD

    def local(batch):
        return {k: torch.as_tensor(v)[shd.local_slices(in_specs[k], tuple(v.shape), mesh)]
                for k, v in batch.items()}

    def mean_over_data(t):
        t = all_reduce(t.detach(), r.data)
        return t / torch.full((), float(r.dp), device=t.device)

    def grads_and_metrics(params, batch):
        names, leaves = zip(*params.named_parameters())
        dev = leaves[0].device
        lb = {k: v.to(dev) for k, v in local(batch).items()}
        shd.set_sequence_parallel(settings.seq_parallel)
        try:
            with _phase("forward", dev):
                inputs = {k: v for k, v in lb.items() if k != "labels"}
                logits, aux = params.forward(inputs, remat=settings.remat,
                                             attention=_attention, rows_split=rows_split)
                labels = lb["labels"]
                mask = torch.ones(labels.shape, dtype=torch.float32, device=dev)
                loss = params.loss_fn(logits, labels, mask)
                total = loss
                if cfg.n_experts:
                    total = total + settings.moe_aux_weight * aux["lb_loss"] \
                        + settings.z_loss_weight * aux["z_loss"]
            with _phase("backward", dev):
                grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                            materialize_grads=True)
        finally:
            shd.set_sequence_parallel(False)
        n = torch.full((), float(r.dp), device=dev)
        out = {}
        for name, g in zip(names, grads):
            if "data" not in shd._used_axes(layer[name]):
                all_reduce_(g, r.data)
            out[name] = g.div_(n)
        metrics = {"loss": mean_over_data(loss), **{k: v.detach() for k, v in aux.items()}}
        return mean_over_data(total), metrics, out

    def update(params, opt, grads, ef=None):
        if settings.grad_compression == "int8":
            grads = compressed_mean_hook(grads, groups=groups, ef=ef, group=world)
            if ef is not None:
                grads, ef = grads
        dev = opt.step.device
        sq = sum((torch.sum(torch.square(g.float())) for name, g in grads.items()
                  if _owns(layer[name], coords)), torch.zeros((), device=dev))
        dist.all_reduce(sq, group=world)
        gnorm = torch.sqrt(sq)
        ps, gs = {}, {}
        for name, p in params.named_parameters():
            if not _holds(moments[name], coords):
                continue
            d = moments[name][2]
            if d is None:
                ps[name], gs[name] = p, grads[name]
            else:
                n = p.shape[d] // r.dp
                ps[name] = p.detach().narrow(d, r.dr * n, n)
                gs[name] = grads[name].narrow(d, r.dr * n, n)
        _, opt, opt_metrics = adamw_update(settings.opt, ps, gs, opt, decay, gnorm=gnorm)
        _share_updates(params, moments, r)
        return opt, ef, opt_metrics

    def step_fn(params, opt, batch):
        total, metrics, grads = grads_and_metrics(params, batch)
        with _phase("optimizer", total.device):
            opt, _, opt_metrics = update(params, opt, grads)
        return params, opt, {**metrics, **opt_metrics, "total_loss": total}

    def step_fn_ef(params, opt, ef, batch):
        total, metrics, grads = grads_and_metrics(params, batch)
        with _phase("optimizer", total.device):
            opt, ef, opt_metrics = update(params, opt, grads, ef)
        return params, opt, ef, {**metrics, **opt_metrics, "total_loss": total}

    return (step_fn_ef if use_ef else step_fn), shardings


@torch.no_grad()
def _share_updates(params, moments: dict, r) -> None:
    """After a ZeRO-1 update each data rank has updated its slice of a
    parameter, or the layers whose moments it holds: gather the slices,
    or broadcast each owned layer from its owner, back over 'data'."""
    from repro_torch.dist.collectives import all_gather
    for name, p in params.named_parameters():
        _, owner, d = moments[name]
        if d is not None:
            n = p.shape[d] // r.dp
            p.copy_(all_gather(p.narrow(d, r.dr * n, n), d, r.data))
        elif owner is not None:
            dist.broadcast(p.detach(), src=dist.get_global_rank(r.data, owner), group=r.data)


def gather_state(params, opt: AdamWState, cfg: ArchConfig, mesh, dst: int = 0):
    """The full state in host memory on global rank ``dst``: ({name:
    parameter}, {name: mu}, {name: nu}); None on every other rank.  One
    leaf at a time goes whole to ``dst`` and on to its host
    (``sharding.gather_to_host``), so no card holds more than one full
    leaf.  A layer whose moments one data rank holds is taken from that
    rank's shards."""
    from repro_torch.dist import sharding as shd
    full_p = {n: shd.gather_to_host(t.detach(), params.specs[n], params.shapes[n], mesh, dst)
              for n, t in params.named_parameters()}
    moms = ({}, {})
    for name, (mspec, owner, _) in moment_layout(cfg, mesh).items():
        shape = params.shapes[name]
        local = tuple(x.stop - x.start for x in shd.local_slices(mspec, shape, mesh))
        holds = None if owner is None else (lambda c, o=owner: c["data"] == o)
        for out, src in zip(moms, (opt.mu, opt.nu)):
            m = src.get(name)
            if m is None:       # another data rank holds this layer: sent, not read
                m = torch.zeros(local, dtype=torch.float32, device=opt.step.device)
            out[name] = shd.gather_to_host(m, mspec, shape, mesh, dst, sources=holds)
    return (full_p, *moms) if dist.get_rank() == dst else None
