"""The sharded runtime of the models over a {data, model} ``DeviceMesh``:
what the reference leaves to GSPMD, written out with ``torch.distributed``
collectives on each rank's local shards (dist/sharding.py's table).

One body of code runs both paths.  ``ShardedLM`` holds this rank's
shards, their specs and full shapes, and hands the one-device model's own
functions (``transformer.lm_forward`` / ``lm_decode_step``,
``encdec.encdec_forward`` / ``encdec_decode_step`` and every block
function under them) two things: a view of its shards shaped like the
one-device model (``_View``: ``view.blocks[3].mixer.wq`` is this rank's
shard of that weight, all-gathered over 'data' where the table shards it
there, FSDP, inside the layer's period, so remat gathers it again in the
backward rather than keeping it), and the mesh context ``dist.tp.TP``,
through which each layer enters and leaves its sharded region.  What the
layers do on the mesh, by kind (the choices are in each module's
docstring):

  * attention by query head (Megatron: ``wq``/``bq``/``wo``; ``wk``/``wv``
    replicated, every rank repeating the K/V heads as the one-device model
    does and taking its own heads'), the whisper encoder's, decoder's and
    cross-attention alike; the FFN by its hidden dim (column-parallel
    ``wi``/``wg``, row-parallel ``wo``); the MoE FFN expert-parallel over
    'data' (``moe_apply_ep``) where the config asks for it, else the whole
    batch's dense dispatch over 'data', the experts' hidden dim over
    'model' either way;
  * Mamba over d_inner: the conv, the scan, ``dt_proj``, ``A_log`` and
    ``D`` on this rank's channels, ``x_proj`` and ``out_proj`` row-
    parallel, the fused ``in_proj`` regrouped by an all-to-all of its
    local product (models/ssm.py);
  * mLSTM over d_x (heads whole on a rank, or a head's columns gathered
    where it spans ranks) and sLSTM, its gate pre-activations gathered
    once before its loop, which every rank runs whole (models/xlstm.py);
  * the embedding and head by vocab row (a masked lookup plus an all-
    reduce; the cross-entropy's max and sum all-reduced over 'model'),
    the vision stub's image embeddings joining before the reduction;
  * sequence parallelism (``sharding.set_sequence_parallel``) for the
    attention-only decoders: the residual stream split along the sequence
    (image positions included) between layers, an all-gather entering
    each sharded layer and a reduce-scatter leaving it;
  * the flash kernel gets this rank's local ``[b/dp, H/tp, s, dh]``
    tensors;
  * decode: a KV cache split along the sequence as the table says
    (``cache_pspecs``: over 'model' where it divides, and with
    ``seq_shard`` over the free dp axes too), every query head attending
    over this rank's positions and the partial softmaxes merged by log-
    sum-exp over each axis of the split; the recurrent states split along
    their largest inner dim, which for Mamba is the weights' split and for
    the xLSTM cells is regrouped at the step.

At world size 1 every collective is an identity and every divisor 1.0, and
the one-device code runs in its own order, so a one-rank step equals the
one-device step bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import _LogSumExp, all_gather, gather_from, reduce_from
from repro_torch.dist.tp import TP, Ranks, _axis_dim

__all__ = ["Ranks", "ShardedLM"]


class _View:
    """A module of the one-device model (``meta``, its twin on the meta
    device) as this rank's layer reads it: a parameter is this rank's
    shard (``ShardedLM._fsdp``), a submodule another view, any other
    attribute the module's own.  Made afresh where a layer runs, so what
    it caches lives as long as that call."""

    def __init__(self, lm: ShardedLM, meta, prefix: str):
        self._lm, self._meta, self._prefix = lm, meta, prefix

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        v = getattr(self._meta, name)
        key = self._prefix + name
        if isinstance(v, torch.nn.Module):
            v = _View(self._lm, v, key + ".")
        elif isinstance(v, torch.Tensor):
            v = self._lm._fsdp(key)
        self.__dict__[name] = v
        return v

    def __getitem__(self, i: int):
        return _View(self._lm, self._meta[i], f"{self._prefix}{i}.")

    def __len__(self):
        return len(self._meta)

    @property
    def _sharded(self) -> bool:
        """Whether the table splits this module's weights over 'model'."""
        return self._lm._module_sharded(self._prefix)

    def _split(self, name: str) -> bool:
        return self._lm._sharded(self._prefix + name)

    def _raw(self, name: str):
        """The local shard itself, not gathered over 'data' (the experts
        of the expert-parallel MoE)."""
        return self._lm.params[self._prefix + name]


class ShardedLM:
    """A model's parameters (a ``transformer.LM`` or an ``encdec.EncDec``)
    as this rank's local shards, keyed by the port's parameter names, with
    the table's per-layer specs (``sharding.layer_specs``) and the full
    shapes.  ``rows_split`` says whether the batch rows are split over
    'data' (the table's input spec), which the expert-parallel MoE needs to
    know; ``sp`` whether the last forward ran sequence parallel."""

    def __init__(self, cfg, mesh, params: dict, specs: dict, shapes: dict):
        from repro_torch.models.model import param_specs
        self.cfg, self.mesh, self.r = cfg, mesh, Ranks.of(mesh)
        self.params, self.specs, self.shapes = params, specs, shapes
        self.meta = param_specs(cfg)
        self.sp = False
        self.rows_split = False
        self.cache_specs = None
        self._split_names = {n for n in params if _axis_dim(specs[n], "model") is not None}
        self._modules: dict = {}

    @classmethod
    def from_model(cls, model, cfg, mesh, *, requires_grad: bool = False) -> ShardedLM:
        """This rank's shards of a full model: its tensors are shared where
        the shard is the whole tensor, copied otherwise."""
        specs = shd.layer_specs(cfg, model, mesh)
        params, shapes = {}, {}
        for name, p in model.named_parameters():
            t = p.detach()
            local = t[shd.local_slices(specs[name], t.shape, mesh)]
            if local.shape != t.shape:
                local = local.clone()
            params[name] = local.requires_grad_(requires_grad)
            shapes[name] = tuple(t.shape)
        return cls(cfg, mesh, params, specs, shapes)

    def named_parameters(self):
        return iter(self.params.items())

    def gather(self) -> dict:
        """{name: the full tensor}, all-gathered from every rank's shard."""
        return {n: shd.gather_tensor(t.detach(), self.specs[n], self.shapes[n], self.mesh)
                for n, t in self.params.items()}

    # -- reading the weights ------------------------------------------------
    def _sharded(self, name: str) -> bool:
        return name in self._split_names

    def _module_sharded(self, prefix: str) -> bool:
        if prefix not in self._modules:
            self._modules[prefix] = any(n.startswith(prefix) for n in self._split_names)
        return self._modules[prefix]

    def _fsdp(self, name: str):
        """A weight as its layer reads it: gathered over 'data' where the
        table shards it there (FSDP)."""
        t = self.params[name]
        d = _axis_dim(self.specs[name], "data")
        return t if d is None else gather_from(t, d, self.r.data)

    def view(self) -> _View:
        """The whole model as this rank's layers read it."""
        return _View(self, self.meta, "")

    def _tp(self, *, cache_spec=None) -> TP:
        return TP(self.r, self.mesh, sp=self.sp, rows_split=self.rows_split,
                  cache_spec=cache_spec)

    def _head_sharded(self) -> bool:
        return self._sharded("lm_head.w" if "lm_head.w" in self.params else "embed")

    def _check_sequence_parallel(self, seq_len: int) -> None:
        cfg, r = self.cfg, self.r
        whole = [n for n in self.params if n.endswith(("mixer.wq", "ffn.wi.w"))
                 and not self._sharded(n)]
        if cfg.is_encdec or set(cfg.block_pattern) != {"attn"} or whole or seq_len % r.tp \
                or not self._sharded("embed") or not self._head_sharded():
            raise ValueError(
                "sequence parallelism needs a decoder of attention blocks whose heads, FFN, "
                f"vocab and sequence ({seq_len}) the model axis ({r.tp}) divides")

    # -- the embedding ------------------------------------------------------
    def embed_tokens(self, tokens):
        """Vocab-parallel lookup: tokens [b, s] -> [b, s, D], whole over
        'model'."""
        dt = getattr(torch, self.cfg.compute_dtype)
        tokens = torch.as_tensor(tokens, device=self.params["embed"].device).long()
        return TP(self.r, self.mesh).embed(self.view(), tokens, dt)

    def vocab_lo(self) -> int:
        """The first vocab id of this rank's slice of the logits."""
        if not self._head_sharded():
            return 0
        if "lm_head.w" in self.params:
            return self.r.mr * self.params["lm_head.w"].shape[-1]
        return self.r.mr * self.params["embed"].shape[0]

    # -- full-sequence forward ------------------------------------------------
    def forward(self, batch, *, remat: bool = False, attention=None,
                rows_split: bool = False):
        """batch: this rank's rows (``rows_split`` if they are a split of
        the batch over 'data') of the model's inputs (``{"tokens"}``, plus
        ``image_embeds`` for the vision stub; ``{"frames", "tokens"}`` for
        the encoder-decoder), or the tokens alone -> (this rank's vocab
        slice of the logits [b, s, V/tp], aux), the one-device forward
        (``models.model.forward``) on this rank's shards."""
        from repro_torch.models import encdec, transformer
        cfg = self.cfg
        dev = self.params["embed"].device
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        self.rows_split = rows_split
        self.sp = shd.sequence_parallel() and self.r.tp > 1
        if self.sp:
            n_img = batch["image_embeds"].shape[1] if "image_embeds" in batch else 0
            self._check_sequence_parallel(batch["tokens"].shape[1] + n_img)
        fwd = encdec.encdec_forward if cfg.is_encdec else transformer.lm_forward
        return fwd(self.view(), cfg, batch, remat=remat, _attention=attention, tp=self._tp())

    def loss_fn(self, logits, labels, mask):
        """``models.model.loss_fn`` on this rank's vocab slice: the
        log-sum-exp and the gold logit reduced over 'model'."""
        lf = logits.float()
        sharded = self._head_sharded()
        lse = _LogSumExp.apply(lf, self.r.model) if sharded else torch.logsumexp(lf, dim=-1)
        labels = torch.as_tensor(labels, device=lf.device)
        mask = torch.as_tensor(mask, device=lf.device)
        want = labels[..., None].long()
        lo = self.vocab_lo()
        hit = torch.arange(lf.shape[-1], device=lf.device) == (want - lo if lo else want)
        gold = torch.where(hit, lf, 0.0).sum(-1)
        if sharded:
            gold = reduce_from(gold, self.r.model)
        nll = (lse - gold) * mask
        return nll.sum() / mask.sum().clamp_min(1)

    # -- cached decode --------------------------------------------------------
    def init_cache(self, batch: int, length: int, specs, dtype=None):
        """This rank's decode cache of a ``batch``-row batch (the whole
        batch's row count) of ``length`` positions (the encoder's, for the
        encoder-decoder), split as ``specs`` says (``make_decode_step``'s
        ``shardings["cache"]``): ``models.model.init_cache``'s tree of
        this rank's slices."""
        from repro_torch.models import encdec, transformer
        dev = self.params["embed"].device
        make = encdec.encdec_init_cache if self.cfg.is_encdec else transformer.init_cache
        full = make(self.cfg, batch, length, dtype, device="meta")
        self.cache_specs = specs

        def local(spec, t):
            sl = shd.local_slices(spec, t.shape, self.mesh)
            return torch.zeros(tuple(x.stop - x.start for x in sl), dtype=t.dtype, device=dev)

        return shd._map_specs(local, specs, full)

    @torch.no_grad()
    def prefill_cache(self, frames, cache: dict) -> dict:
        """The encoder-decoder's cross-attention K/V from this rank's rows
        of ``frames`` (``encdec.encdec_prefill_cache``), this rank's slice
        of the frames where the cache's spec splits them."""
        from repro_torch.models import encdec
        self.sp = False
        frames = torch.as_tensor(frames, device=self.params["embed"].device)
        return encdec.encdec_prefill_cache(self.view(), self.cfg, frames, cache,
                                           tp=self._tp(cache_spec=self.cache_specs))

    @torch.no_grad()
    def decode_step(self, token, cache, pos_scalar: int, *, rows_split: bool = False):
        """token [b] (this rank's rows) -> (logits [b, V] whole, gathered
        over 'model'; the new cache), the one-device decode step
        (``models.model.decode_step``) on this rank's shards and cache."""
        from repro_torch.models import encdec, transformer
        self.sp, self.rows_split = False, rows_split
        tp = self._tp(cache_spec=self.cache_specs)
        if self.cfg.is_encdec:
            logits, cache = encdec.encdec_decode_step(self.view(), self.cfg, token, cache,
                                                      pos_scalar, tp)
        else:
            logits, cache = transformer.lm_decode_step(self.view(), self.cfg, token, cache,
                                                       pos_scalar, tp=tp)
        if self._head_sharded():
            logits = all_gather(logits, 1, self.r.model)
        return logits, cache
