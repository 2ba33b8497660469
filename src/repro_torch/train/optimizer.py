"""AdamW and its learning-rate schedule (port of ``repro/train/optimizer.py``).

The state mirrors the parameters: two float32 moment tensors per
parameter and a step counter, each held as a dict keyed by parameter name
(``AdamWState``).  ``adamw_update`` follows the reference's expressions in
their order (the clip scale, the step counted before ``lr_at``, ``b1 **
step`` in float32, ``(mu / b1c) / (sqrt(nu / b2c) + eps)``, then the decay
added to the update) and writes the parameters and moments in place under
``no_grad``; parameters keep their dtype.  Weight decay applies where the
reference's ``_decay_mask`` says, on the reference's key paths
(``models/convert.py:reference_layout``), so exactly the reference's leaves
decay.  Every scalar stays on the device: a step waits for nothing, and a
Python number never divides a tensor (on the card that division is a
product with the reciprocal, not the reference's quotient).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: dict                    # {parameter name: float32 tensor}
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(like: torch.Tensor, x: float) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device (a fill, not a copy
    from the host)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``."""
    step = step.float()
    warm = step / _f32(step, max(cfg.warmup_steps, 1))
    t = (step - cfg.warmup_steps) / _f32(step, max(cfg.total_steps - cfg.warmup_steps, 1))
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> AdamWState:
    """Zero moments for every parameter of a model (or a {name: tensor}
    dict), the step at 0 on the parameters' device."""
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") else params
    dev = next(iter(named.values())).device
    zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in named.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the tensors, in order, of their float32 sums of
    squares."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))


def _decay_mask(path: str) -> bool:
    """No weight decay on norms, biases, 1-d params: the reference's test on
    its ``/``-joined key path, substring quirks included."""
    return not any(k in path for k in ("norm", "bias", "/b", "b_if", "A_log"))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState,
                 decay: dict, *, gnorm: torch.Tensor | None = None):
    """One AdamW step.  ``params`` and ``grads`` are {name: tensor};
    ``decay`` {name: bool} (``_decay_mask`` of each name's reference path).
    Writes the parameters and the moments in place and returns (params,
    new state, metrics {grad_norm, lr}).  ``gnorm`` is the gradients'
    global norm when ``grads`` hold only this rank's shards (the sharded
    train step computes it over the ranks); None computes it here."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(_f32(gnorm, cfg.grad_clip) / gnorm.clamp_min(1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(_f32(gnorm, cfg.b1), step.float())
    b2c = 1 - torch.pow(_f32(gnorm, cfg.b2), step.float())
    for name, p in params.items():
        g = grads[name].float() * scale
        mu, nu = state.mu[name], state.nu[name]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        u = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if decay[name]:
            u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
