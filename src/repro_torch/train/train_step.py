"""The training step (port of ``repro/train/train_step.py``): loss, grad,
the optional int8 compression (with error feedback), AdamW, with
activation checkpoints by period of the block pattern.

``make_train_step(cfg, settings)`` returns ``step_fn(params, opt, batch)
-> (params, opt, metrics)`` or, with int8 compression and error feedback,
``step_fn_ef(params, opt, ef, batch) -> (params, opt, ef, metrics)``.
``params`` is the model (``init_all`` makes its parameters require grad);
the step writes it and the optimizer's moments in place.  The metrics are
the reference's: ``loss``, the aux keys, ``grad_norm``, ``lr`` and
``total_loss``, as scalars on the model's device (the step waits for
nothing).  The int8 hook gives each stacked leaf of the reference's tree
one scale, over the per-layer parameters it stands for, so its numerics are
the reference's.  The reference's shardings and sequence parallelism
belong to the sharding slice (ROADMAP); on one device the step is the
reference's step on one device.

While torch.profiler runs, a step opens ``train.forward``,
``train.backward`` and ``train.optimizer`` ranges and waits for the card
at the end of each, so a profile splits the step's device time by phase.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.compression import compressed_mean_hook, init_ef_state
from repro_torch.models import model as M
from repro_torch.models.convert import path_str, reference_layout
from repro_torch.train.optimizer import (AdamWConfig, _decay_mask, adamw_update,
                                         init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    opt: AdamWConfig = AdamWConfig()
    remat: bool = True
    moe_aux_weight: float = 0.01
    z_loss_weight: float = 1e-3
    grad_compression: str = "none"     # none | int8
    error_feedback: bool = False       # persistent EF state for int8 grads


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


def make_train_step(cfg: ArchConfig, settings: TrainSettings = TrainSettings(), *,
                    _attention=None):
    """-> ``step_fn`` (or ``step_fn_ef``, with int8 compression and error
    feedback; start it from ``init_all(..., error_feedback=True)``).
    ``_attention`` (private) replaces the attention entry point, so the
    card can run the plain version and compare."""
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
