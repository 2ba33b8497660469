"""Serving steps: prefill and cached greedy decode (port of
``repro/serve/serve_step.py``).

Without a mesh each builder returns the step function alone, on one
device.  With a {data, model} ``DeviceMesh`` (launch/mesh.py) it returns
(step function, shardings) as the reference's builders do; the step then
runs on this rank's shards (``dist.parallel.ShardedLM``) and the
shardings are the table's specs (``param_pspecs``, ``cache_pspecs``, the
token and logits specs).  The kNN-LM mixing hooks in through
``make_knnlm_mixer`` and serve/knnlm.py.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class ServeSettings:
    """The reference's serving settings that change the port's program:
    its ``temperature`` and ``greedy`` both pick the argmax, so they are
    not carried."""
    seq_shard_cache: bool = False   # long-context: fold dp axes into the KV split


def _token_spec(mesh, batch: int):
    """The token batch's spec: over the dp axes when they divide it."""
    from repro_torch.dist import sharding as shd
    dp = shd.batch_dp(mesh)
    sizes = shd._mesh_sizes(mesh)
    n = 1
    for a in shd._axes_of(dp):
        n *= sizes[a]
    return shd.Spec((dp,) if batch % n == 0 and batch >= n else (None,))


def make_decode_step(cfg: ArchConfig, mesh=None, shape=None,
                     settings: ServeSettings = ServeSettings()):
    """decode_fn(params, token, cache, pos) -> (next_token, logits, cache),
    the next token greedy (argmax).  With a ``mesh`` (and the cell's
    ``shape``: its batch and cache length), (decode_fn, shardings): the
    function takes this rank's rows of the token batch (``shardings
    ["token"]``), a ``ShardedLM`` and its cache (``ShardedLM.init_cache``)
    and returns those rows' tokens and whole-vocab logits."""

    if mesh is None:
        def decode_fn(params, token, cache, pos):
            logits, cache = M.decode_step(params, cfg, token, cache, pos)
            return logits.argmax(-1).to(torch.int32), logits, cache

        return decode_fn

    from repro_torch.dist import sharding as shd
    tok_spec = _token_spec(mesh, shape.global_batch)
    rows_split = tok_spec[0] is not None

    def sharded_decode_fn(params, token, cache, pos):
        logits, cache = params.decode_step(token, cache, int(pos), rows_split=rows_split)
        return logits.argmax(-1).to(torch.int32), logits, cache

    meta = M.param_specs(cfg)
    pspecs = shd.param_pspecs(cfg, meta, mesh)
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    shardings = dict(params=pspecs,
                     cache=(shd.cache_pspecs if cfg.is_encdec else shd.layer_cache_specs)(
                         cfg, cache, mesh, seq_shard=settings.seq_shard_cache),
                     token=tok_spec, logits=shd.Spec((tok_spec[0], "model")),
                     pos=shd.Spec(), pspecs=pspecs)
    return sharded_decode_fn, shardings


def make_knnlm_mixer(cfg: ArchConfig, mesh, shape, store, lam: float | None = None):
    """(mix_fn, query spec): ``mix_fn(logits, h)`` runs the [b, D] hidden-
    state cohort through the datastore's kNN and returns the interpolated
    logits.  The store shards the cohort's rows over the dp axes
    (``query_pspecs``) against its own copy of the tree on every rank and
    gathers the results, so ``mix_fn`` takes and returns whole rows."""
    from repro_torch.dist import sharding as shd
    from repro_torch.serve.knnlm import mix_logits
    del cfg
    store.mesh = mesh
    lam = store.cfg.lam if lam is None else lam

    def mix_fn(logits, h):
        return mix_logits(logits, store.knn_logits(h.float(), logits.shape[-1]), lam)

    return mix_fn, shd.query_pspecs(mesh, shape.global_batch)


def make_prefill_step(cfg: ArchConfig, mesh=None, shape=None, *, _attention=None,
                      _routing=None):
    """prefill_fn(params, batch) -> logits [b, s, V]: the full-sequence
    forward (the flash kernel on the card).  With a ``mesh``,
    (prefill_fn, shardings): the function takes a ``ShardedLM`` and the
    whole batch, of which it runs this rank's rows (``shardings["batch"]``)
    on this rank's heads, and returns those rows' logits on this rank's
    vocab slice (``logits_pspec``).  ``_attention`` (private) replaces the
    attention entry point, for comparisons on the card; ``_routing``
    (private, a list; one device only) collects each MoE layer's routing
    and aux values (models/moe.py)."""

    if mesh is None:
        def prefill_fn(params, batch):
            logits, _ = M.forward(params, cfg, batch, _attention=_attention,
                                  _routing=_routing)
            return logits

        return prefill_fn

    from repro_torch.dist import sharding as shd
    inputs = {"tokens": torch.empty((shape.global_batch, shape.seq_len), device="meta")}
    in_specs = shd.input_pspecs(cfg, "prefill", inputs, mesh)
    rows_split = in_specs["tokens"][0] is not None

    @torch.no_grad()
    def sharded_prefill_fn(params, batch):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        specs = shd.input_pspecs(cfg, "prefill", batch, mesh)
        local = {k: v[shd.local_slices(specs[k], tuple(v.shape), mesh)] for k, v in batch.items()}
        logits, _ = params.forward(local, attention=_attention, rows_split=rows_split)
        return logits

    pspecs = shd.param_pspecs(cfg, M.param_specs(cfg), mesh)
    shardings = dict(params=pspecs, batch=in_specs, logits=shd.logits_pspec(mesh),
                     pspecs=pspecs)
    return sharded_prefill_fn, shardings
