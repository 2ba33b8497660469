"""The sharded runtime of the decoder LM over a {data, model} ``DeviceMesh``:
what the reference leaves to GSPMD, written out with ``torch.distributed``
collectives on each rank's local shards (dist/sharding.py's table).

  * Tensor parallelism over 'model' (Megatron): attention by query head
    (``wq``/``bq``/``wo``; ``wk``/``wv`` replicated, every rank repeating
    the K/V heads as the one-device model does and taking its own heads'
    slice), the FFN by its hidden dim (column-parallel ``wi``/``wg``,
    row-parallel ``wo``: one all-reduce after the row-parallel product),
    the embedding and tied head by vocab row (a masked lookup plus an
    all-reduce; the cross-entropy's max and sum all-reduced over 'model').
    Weights that the table replicates but a sharded layer reads (``wk``,
    ``wv``, their biases, a column-parallel layer's bias) pass through
    ``copy_to`` (identity forward, all-reduce backward), so their
    gradients are whole on every rank.
  * Sequence parallelism (``sharding.set_sequence_parallel``): the
    residual stream stays split along the sequence over 'model' between
    layers; an all-gather enters each sharded layer and a reduce-scatter
    leaves it, and the norms' weights, which then see a slice of the
    sequence, pass through ``copy_to``.
  * FSDP over 'data': a leaf that the table shards over 'data' is
    all-gathered along that dim where a layer reads it (backward: a
    reduce-scatter, the sum over the data ranks), inside the layer's
    period, so remat gathers it again in the backward rather than keeping
    it.
  * The flash kernel is a custom op with no sharding rule: it gets this
    rank's local ``[b/dp, H/tp, s, dh]`` tensors.
  * Decode: the KV cache is split along the sequence as the table says
    (``cache_pspecs``: over 'model' where it divides, and with
    ``seq_shard`` over the free dp axes too); each rank attends with every
    query head over its own positions (``attention_plain.
    decode_attention`` on the slice) and the partial softmaxes merge by
    log-sum-exp over each axis of the split (a MAX then a SUM all-reduce),
    after which each rank keeps its heads for the row-parallel output
    projection.
  * The layers run through ``transformer.run_periods``, the one-device
    trunk's period loop, and the MLP's activation is ``layers.
    mlp_hidden``'s.

At world size 1 every collective is an identity and every divisor 1.0, and
each function here runs the one-device model's operations in its order
(``models/transformer.py``), so a one-rank step equals the one-device step
bitwise.  Block kinds: ``attn`` and ``attn_moe`` (the MoE FFN expert-
parallel over 'data' through ``models/moe.py:moe_apply_ep`` when the
config asks for it, else the whole batch's dense dispatch over 'data';
the experts' hidden dim over 'model' either way); the tensor-parallel
runtime of the Mamba, xLSTM and encoder-decoder blocks is not ported yet
(ROADMAP Queue 1 item 17, its next part).
"""
from __future__ import annotations

import dataclasses
import types

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import (_LogSumExp, all_gather, all_reduce_, copy_to,
                                          gather_from, reduce_from, scatter_to)
from repro_torch.kernels.attention_plain import decode_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_norm, dense, mlp_hidden
from repro_torch.models.transformer import _span, aux_means, run_periods

SUPPORTED_KINDS = ("attn", "attn_moe")


# ---------------------------------------------------------------------------
# the mesh as this rank sees it
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Ranks:
    """A {data, model} ``DeviceMesh`` from this rank: its two groups, their
    sizes and this rank's coordinate in each."""
    data: object
    model: object
    dp: int
    tp: int
    dr: int
    mr: int

    @classmethod
    def of(cls, mesh) -> Ranks:
        names = tuple(mesh.mesh_dim_names or ())
        if names != ("data", "model"):
            raise ValueError(f"the sharded runtime takes a ('data', 'model') mesh, not {names}")
        sizes = shd._mesh_sizes(mesh)
        return cls(mesh.get_group("data"), mesh.get_group("model"),
                   sizes["data"], sizes["model"], mesh.get_local_rank("data"),
                   mesh.get_local_rank("model"))


def _axis_dim(spec, axis: str):
    """The tensor dim whose entry names ``axis``, or None."""
    return next((d for d, e in enumerate(spec) if axis in shd._axes_of(e)), None)


# ---------------------------------------------------------------------------
# the sharded decoder LM
# ---------------------------------------------------------------------------
class ShardedLM:
    """A decoder LM's parameters as this rank's local shards, keyed by the
    port's parameter names (``transformer.LM``), with the table's per-layer
    specs (``sharding.layer_specs``) and the full shapes.  ``rows_split``
    says whether the batch rows are split over 'data' (the table's input
    spec), which the expert-parallel MoE needs to know."""

    def __init__(self, cfg, mesh, params: dict, specs: dict, shapes: dict):
        kinds = set(cfg.block_pattern)
        if cfg.is_encdec or not kinds <= set(SUPPORTED_KINDS):
            raise NotImplementedError(
                f"the tensor-parallel runtime of {sorted(kinds - set(SUPPORTED_KINDS)) or 'enc-dec'}"
                " blocks is not ported yet (ROADMAP Queue 1 item 17, its next part)")
        if cfg.frontend == "vision_stub":
            raise NotImplementedError("the sharded runtime feeds tokens only")
        self.cfg, self.mesh, self.r = cfg, mesh, Ranks.of(mesh)
        self.params, self.specs, self.shapes = params, specs, shapes
        self.sp = False
        self.rows_split = False
        self.cache_specs = None

    @classmethod
    def from_model(cls, model, cfg, mesh, *, requires_grad: bool = False) -> ShardedLM:
        """This rank's shards of a full model (a ``transformer.LM``): its
        tensors are shared where the shard is the whole tensor, copied
        otherwise."""
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
        return _axis_dim(self.specs[name], "model") is not None

    def _fsdp(self, name: str):
        """A weight as its layer reads it: gathered over 'data' where the
        table shards it there (FSDP)."""
        t = self.params.get(name)
        if t is None:
            return None
        d = _axis_dim(self.specs[name], "data")
        return t if d is None else gather_from(t, d, self.r.data)

    def _rep(self, name: str, through: bool):
        """A weight that the table replicates over 'model', through
        ``copy_to`` when ``through`` (read inside a sharded layer, or on a
        slice of the sequence), so its gradient is whole."""
        t = self._fsdp(name)
        return copy_to(t, self.r.model) if t is not None and through else t

    def _col_bias(self, name: str, width: int, sharded: bool):
        """A column-parallel layer's bias (replicated by the table): its
        ``width`` columns of this rank."""
        b = self._rep(name, sharded)
        if b is None or b.shape[-1] == width:
            return b
        return b[..., self.r.mr * width:(self.r.mr + 1) * width]

    def _norm(self, prefix: str, x):
        return apply_norm(self._rep(f"{prefix}.scale", self.sp),
                          self._rep(f"{prefix}.bias", self.sp), x, self.cfg.norm,
                          self.cfg.norm_eps)

    # -- entering and leaving a sharded layer -------------------------------
    def _enter(self, h, sharded: bool):
        if self.sp:
            return gather_from(h, 1, self.r.model)
        return copy_to(h, self.r.model) if sharded else h

    def _leave(self, y, sharded: bool):
        if self.sp:
            return scatter_to(y, 1, self.r.model)
        return reduce_from(y, self.r.model) if sharded else y

    def _head_sharded(self) -> bool:
        return self._sharded("embed" if self.cfg.tie_embeddings else "lm_head.w")

    def _check_sequence_parallel(self, seq_len: int) -> None:
        cfg, r = self.cfg, self.r
        whole = [n for n in self.params if n.endswith(("mixer.wq", "ffn.wi.w"))
                 and not self._sharded(n)]
        if set(cfg.block_pattern) != {"attn"} or whole or seq_len % r.tp \
                or not self._sharded("embed") or not self._head_sharded():
            raise ValueError(
                "sequence parallelism needs attention blocks whose heads, FFN, vocab "
                f"and sequence ({seq_len}) the model axis ({r.tp}) divides")

    # -- layers -------------------------------------------------------------
    def embed_tokens(self, tokens):
        """Vocab-parallel lookup: tokens [b, s] -> [b, s, D] in the
        residual stream's layout (this rank's slice of the sequence under
        sequence parallelism)."""
        dt = getattr(torch, self.cfg.compute_dtype)
        table = self.params["embed"]
        if not self._sharded("embed"):
            return self._seq_slice(table[tokens], 1).to(dt)
        n = table.shape[0]
        idx = tokens - self.r.mr * n
        ok = (idx >= 0) & (idx < n)
        e = torch.where(ok[..., None], table[idx.clamp(0, n - 1)], 0.0)
        return self._leave(e, True).to(dt)

    def _seq_slice(self, y, dim: int):
        if not self.sp:
            return y
        n = y.shape[dim] // self.r.tp
        return y.narrow(dim, self.r.mr * n, n)

    def _attention_weights(self, pre: str, sharded: bool):
        wq = self._fsdp(f"{pre}.wq")
        hl = wq.shape[1]
        return types.SimpleNamespace(
            wq=wq, wk=self._rep(f"{pre}.wk", sharded), wv=self._rep(f"{pre}.wv", sharded),
            wo=self._fsdp(f"{pre}.wo"), bq=self._fsdp(f"{pre}.bq"),
            bk=self._rep(f"{pre}.bk", sharded), bv=self._rep(f"{pre}.bv", sharded),
            lo=self.r.mr * hl if sharded else 0, hl=hl)

    def attention(self, layer: int, h, pos, attention=None):
        """Causal attention on this rank's heads: h [b, s, D] (the whole
        sequence) -> this rank's partial [b, s, D]."""
        pre = f"blocks.{layer}.mixer"
        p = self._attention_weights(pre, self._sharded(f"{pre}.wq"))
        return attn_mod.attn_apply(p, self.cfg, h, pos=pos, attention=attention, lo=p.lo)

    def mlp(self, pre: str, h):
        """The MLP under ``pre`` on its local hidden columns: -> (this
        rank's partial output before the row-parallel bias, sharded?)."""
        wi = self._fsdp(f"{pre}.wi.w")
        fl, sharded = wi.shape[-1], self._sharded(f"{pre}.wi.w")
        bi = lambda n: self._col_bias(f"{pre}.{n}.b", fl, sharded)
        wg = self._fsdp(f"{pre}.wg.w")
        a = mlp_hidden(h, lambda x: dense(wi, bi("wi"), x),
                       None if wg is None else (lambda x: dense(wg, bi("wg"), x)))
        return dense(self._fsdp(f"{pre}.wo.w"), None, a)

    def ffn(self, pre: str, h):
        """An MLP as a layer: h (residual layout) -> its output, whole (or
        this rank's sequence slice), its row-parallel bias added after the
        reduction, in the one-device ``h @ wo + b`` order."""
        sharded = self._sharded(f"{pre}.wi.w")
        y = self._leave(self.mlp(pre, self._enter(h, sharded)), sharded)
        b = self._rep(f"{pre}.wo.b", self.sp)
        return y if b is None else y + b.to(y.dtype)

    def moe(self, layer: int, h, capacity=None):
        """The MoE FFN on this rank's tokens (h whole over 'model'):
        expert-parallel over 'data' (``moe_apply_ep``) where the config and
        the batch allow it, else the whole batch's dense dispatch
        (``moe_apply(data_group=)``) with every expert gathered; the
        experts' hidden dim over 'model' either way."""
        from repro_torch.models import moe as moe_mod
        cfg, r = self.cfg, self.r
        pre = f"blocks.{layer}.ffn"
        model_group = r.model if self._sharded(f"{pre}.wi") else None
        ep = (cfg.moe_ep and capacity is None and self.rows_split
              and moe_mod.ep_applies(cfg, h.shape[0] * r.dp, r.data))
        # decode's dropless capacity is local; training's is the batch's
        data_group = r.data if capacity is None and self.rows_split and r.dp > 1 else None
        get = (lambda n: self.params[n]) if ep else self._fsdp
        p = types.SimpleNamespace(router=self._fsdp(f"{pre}.router"), wi=get(f"{pre}.wi"),
                                  wg=get(f"{pre}.wg"), wo=get(f"{pre}.wo"), shared=None)
        if ep:
            y, aux = moe_mod.moe_apply_ep(p, cfg, h, capacity, group=r.data,
                                          model_group=model_group)
        else:
            y, aux = moe_mod.moe_apply(p, cfg, h, capacity, model_group=model_group,
                                       data_group=data_group)
        if f"{pre}.shared.wi.w" in self.params:
            y = y + self.ffn(f"{pre}.shared", h)
        return y, aux

    def block(self, layer: int, x, pos, attention=None):
        """One pre-norm block -> (x, aux or None); x in the residual
        stream's layout."""
        cfg = self.cfg
        kind = cfg.block_pattern[layer % len(cfg.block_pattern)]
        h = self._norm(f"blocks.{layer}.norm1", x)
        sharded = self._sharded(f"blocks.{layer}.mixer.wq")
        with _span("attn"):
            x = x + self._leave(self.attention(layer, self._enter(h, sharded), pos, attention),
                                sharded)
        h = self._norm(f"blocks.{layer}.norm2", x)
        if kind == "attn_moe":
            with _span("moe"):
                y, aux = self.moe(layer, h)
            return x + y, aux
        if cfg.d_ff == 0:
            return x, None
        with _span("mlp"):
            return x + self.ffn(f"blocks.{layer}.ffn", h), None

    def head(self, x):
        """Final-normed hidden states -> this rank's vocab slice of the
        logits."""
        x = self._enter(x, self._head_sharded())
        if self.cfg.tie_embeddings:
            return x @ self.params["embed"].T.to(x.dtype)
        return dense(self._fsdp("lm_head.w"), None, x)

    def vocab_lo(self) -> int:
        """The first vocab id of this rank's slice of the logits."""
        if not self._head_sharded():
            return 0
        t = self.params["embed"] if self.cfg.tie_embeddings else self.params["lm_head.w"]
        return self.r.mr * t.shape[0 if self.cfg.tie_embeddings else -1]

    # -- full-sequence forward ------------------------------------------------
    def forward(self, tokens, *, remat: bool = False, attention=None,
                rows_split: bool = False):
        """tokens [b, s] (this rank's rows; ``rows_split`` if they are a
        split of the batch over 'data') -> (this rank's vocab slice of the
        logits [b, s, V/tp], aux), as ``transformer.lm_forward``: layers by
        period of the block pattern, each period one activation checkpoint
        with ``remat`` while autograd records."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.params["embed"].device).long()
        self.rows_split = rows_split
        self.sp = shd.sequence_parallel() and self.r.tp > 1
        if self.sp:
            self._check_sequence_parallel(tokens.shape[1])
        x = self.embed_tokens(tokens)
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        if cfg.pos_embedding == "learned":
            x = x + self._seq_slice(self._rep("pos_embed", self.sp)[:s], 0).to(x.dtype)
        x, sums = run_periods(cfg, x, lambda layer, x: self.block(layer, x, pos, attention),
                              remat)
        return self.head(self._norm("final_norm", x)), aux_means(cfg, sums)

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
    def init_cache(self, batch: int, length: int, specs: list, dtype=None):
        """This rank's decode cache of a ``batch``-row batch (the whole
        batch's row count) of ``length`` positions, split as ``specs`` says
        (``make_decode_step``'s ``shardings["cache"]``, the table's
        ``layer_cache_specs``): each layer's ``{"kv": (k, v)}``."""
        from repro_torch.models import transformer
        dev = self.params["embed"].device
        full = transformer.init_cache(self.cfg, batch, length, dtype, device="meta")
        self.cache_specs = specs

        def make(t, spec):
            sl = shd.local_slices(spec, t.shape, self.mesh)
            return torch.zeros(tuple(x.stop - x.start for x in sl), dtype=t.dtype, device=dev)

        return [{"kv": tuple(make(t, s) for t, s in zip(c["kv"], sp["kv"]))}
                for c, sp in zip(full, specs)]

    def _decode_attention(self, layer: int, h, kv, pos_scalar: int):
        """One position's attention (``attn_decode``'s operations): every
        query head over this rank's slice of the sequence, the cache split
        over the axes its spec names there ('model', and under
        ``seq_shard`` the free dp axes too), or whole; the partial softmaxes
        merge by log-sum-exp over each of those axes (``decode_attention``'s
        max, then its sums, all-reduced).  Then this rank's heads go into
        the row-parallel output projection."""
        cfg, r = self.cfg, self.r
        pre = f"blocks.{layer}.mixer"
        sharded = self._sharded(f"{pre}.wq")
        p = self._attention_weights(pre, sharded)
        b, dev = h.shape[0], h.device
        pos = torch.full((b, 1), pos_scalar, dtype=torch.int32, device=dev)
        q, k, v = attn_mod._project_qkv(p, cfg, h, pos)
        if sharded:
            q = all_gather(q, 1, r.model)                 # every query head
        ck, cv = kv
        seq = shd._axes_of(self.cache_specs[layer]["kv"][0][2])
        S = ck.shape[2]
        lo = shd.shard_index(seq, self.mesh)[0] * S
        idx = torch.arange(lo, lo + S, device=dev)
        hit = (idx == pos_scalar)[None, None, :, None]
        ck = torch.where(hit, k.to(ck.dtype), ck)
        cv = torch.where(hit, v.to(cv.dtype), cv)
        kv_len = torch.full((b,), pos_scalar + 1, dtype=torch.int32, device=dev)
        groups = [self.mesh.get_group(a) for a in seq]
        ops_ = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

        def merge(t, op):
            for g in groups:
                all_reduce_(t, g, ops_[op])

        out = decode_attention(q, ck.to(q.dtype), cv.to(q.dtype), kv_len=kv_len,
                               positions=idx, merge=merge if groups else None)
        if sharded:
            out = out[:, p.lo:p.lo + p.hl]
        y = attn_mod._out_proj(p, attn_mod._head_mask(cfg, out, p.lo))
        return (reduce_from(y, r.model) if sharded else y), (ck, cv)

    @torch.no_grad()
    def decode_step(self, token, cache, pos_scalar: int, *, rows_split: bool = False):
        """token [b] (this rank's rows) -> (logits [b, V] whole, gathered
        over 'model'; the new cache), as ``transformer.lm_decode_step``."""
        cfg = self.cfg
        self.sp, self.rows_split = False, rows_split
        token = torch.as_tensor(token, device=self.params["embed"].device).long()
        x = self.embed_tokens(token[:, None])
        if cfg.pos_embedding == "learned":
            x = x + self.params["pos_embed"][pos_scalar][None, None].to(x.dtype)
        new_cache = []
        for layer, c in enumerate(cache):
            kind = cfg.block_pattern[layer % len(cfg.block_pattern)]
            h = self._norm(f"blocks.{layer}.norm1", x)
            y, kv = self._decode_attention(layer, h, c["kv"], pos_scalar)
            x = x + y
            new_cache.append({"kv": kv})
            h = self._norm(f"blocks.{layer}.norm2", x)
            if kind == "attn_moe":
                # dropless at decode: at worst every token routes to one expert
                x = x + self.moe(layer, h, capacity=x.shape[0])[0]
            elif cfg.d_ff:
                x = x + self.ffn(f"blocks.{layer}.ffn", h)
        logits = self.head(self._norm("final_norm", x))[:, 0]
        if self._head_sharded():
            logits = all_gather(logits, 1, self.r.model)
        return logits, new_cache
