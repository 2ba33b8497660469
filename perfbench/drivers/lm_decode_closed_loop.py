"""kNN-LM decoding: a closed loop of batches of greedy requests through the
port's serving steps.

Each batch holds ``batch`` requests with seeded ``prompt_len``-token
prompts.  As ``launch/serve.py:serve_loop`` serves them, the prompt is fed
through the cached decode step (``serve_step.make_decode_step``) one
position at a time, the last prompt position's argmax is the first
generated token, then ``gen_steps`` steps each feed the last token, mix
the model's logits with the datastore's kNN log-probs
(``serve/knnlm.py``: ``KnnLmDatastore.knn_logits`` and ``mix_logits``,
as ``serve_loop`` calls them; the query key is the fed token's
embedding) and take the argmax of the mixed logits.  When a batch ends the
next starts with a fresh cache.

The rate is every token generated by the steps issued in the window, over
the window up to the synchronise that ends it.  Requests in flight when
the window closes are served to their end afterwards (not timed), and a
seeded sample of each batch's requests is held to the plain reference: a
float32 forward over the prompt and the served tokens, a brute-force kNN
and the same mix, at every served position.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import datagen, lm_weights, roofline
from perfbench.drivers._common import free_device, frontier_roofline
from perfbench.harness import Check, Outcome

ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
             "qkv_bias", "norm", "norm_eps", "gated_mlp", "rope_theta", "tie_embeddings")


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of the registered arch with the file's
    numbers (equal to the registry's at the published sizes)."""
    from repro_torch.configs.base import get_config
    if cfg["gated_mlp"] or cfg["tie_embeddings"] or cfg["dtype"] != "float32":
        raise ValueError("the reference covers the untied, ungated float32 decoder only")
    return get_config(cfg["arch"], **{k: cfg[k] for k in ARCH_KEYS},
                      d_head=cfg["d_model"] // cfg["n_heads"],
                      param_dtype="float32", compute_dtype="float32")


class Batch:
    """One batch of requests, stepped one decode step at a time.  What the
    check reads is copied into buffers made with the batch, so the window
    allocates nothing of the benchmark's own step by step; the cache is
    let go when the batch ends, as a server would."""

    def __init__(self, index: int, prompt, rows, cache, P: int, G: int, V: int):
        self.index, self.prompt, self.rows, self.cache = index, prompt, rows, cache
        self.P, self.G = P, G
        self.pos = 0
        self.tok = None
        B, R, dev = prompt.shape[0], rows.shape[0], prompt.device
        self.out = torch.empty((1 + G, B), dtype=torch.int32, device=dev)  # generated tokens
        self.first = torch.empty((R, V), device=dev)   # captured rows' last prompt logits
        self.mixed = torch.empty((G, R, V), device=dev)  # captured rows' mixed logits

    @property
    def done(self) -> bool:
        return self.pos == self.P + self.G

    def step(self, params, step_fn, mix_fn, embed, sync=None) -> tuple[int, float, float | None]:
        """One decode step -> (tokens generated, the model part's seconds,
        the mix part's seconds) where ``sync`` (a laps sync) is given."""
        t0 = time.perf_counter()
        if self.pos < self.P:
            self.tok, logits, self.cache = step_fn(params, self.prompt[:, self.pos],
                                                   self.cache, self.pos)
            if sync:
                sync()
            t1 = time.perf_counter()
            self.pos += 1
            if self.pos < self.P:
                return 0, t1 - t0, None
            self.first.copy_(logits[self.rows])
            self.out[0].copy_(self.tok)
            return self.tok.shape[0], t1 - t0, None
        fed = self.tok
        tok, logits, self.cache = step_fn(params, fed, self.cache, self.pos)
        if sync:
            sync()
        t1 = time.perf_counter()
        mixed = mix_fn(logits, embed[fed.long()].float())
        self.tok = mixed.argmax(-1).to(fed.dtype)
        i = self.pos - self.P
        self.mixed[i].copy_(mixed[self.rows])
        self.out[i + 1].copy_(self.tok)
        if sync:
            sync()
        self.pos += 1
        if self.done:
            self.cache = None
        return self.tok.shape[0], t1 - t0, time.perf_counter() - t1


def run(ctx) -> Outcome:
    from repro_torch.models import model as M
    from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore, mix_logits
    from repro_torch.serve.serve_step import make_decode_step

    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    acfg = arch_config(cfg)
    B, P, G, R = tr["batch"], tr["prompt_len"], tr["gen_steps"], tr["check_rows"]
    D, V = cfg["d_model"], cfg["vocab_size"]
    W = lm_weights.make(cfg, ctx.seed, dev)
    params = lm_weights.to_program(W, cfg)
    kgen = torch.Generator(device=dev).manual_seed(datagen.torch_seed(ctx.seed, "keys"))
    keys = torch.randn((cfg["datastore_keys"], D), generator=kgen, device=dev)
    values = datagen.rng(ctx.seed, "values").integers(0, V, cfg["datastore_keys"]).astype(np.int32)
    store = KnnLmDatastore(KnnLmConfig(k=cfg["knn_k"], lam=cfg["lam"],
                                       temperature=cfg["temperature"], metric=cfg["metric"],
                                       capacity=cfg["capacity"],
                                       max_frontier=cfg["max_frontier"]), D, device=dev)
    store.build(keys.cpu().numpy(), values)
    step_fn = make_decode_step(acfg)
    lam = cfg["lam"]

    def mix_fn(logits, h):
        # serve_loop's mix (make_knnlm_mixer's function without a mesh,
        # which that builder does not take: its query spec needs one)
        return mix_logits(logits, store.knn_logits(h, logits.shape[-1]), lam)
    prompts = datagen.rng(ctx.seed, "prompts")
    sample = datagen.rng(ctx.seed, "sample")

    def new_batch(i: int) -> Batch:
        prompt = torch.from_numpy(prompts.integers(0, V, (B, P)).astype(np.int32)).to(dev)
        rows = torch.from_numpy(np.sort(sample.choice(B, R, replace=False))).to(dev)
        return Batch(i, prompt, rows, M.init_cache(acfg, B, P + G + 1, device=dev), P, G, V)

    # warm-up: a batch of the cell's shapes (two prompt positions, then
    # two mixed steps), on its own cache; nothing of it is served
    warm = Batch(-1, torch.zeros((B, 2), dtype=torch.int32, device=dev),
                 torch.arange(R, device=dev), M.init_cache(acfg, B, P + G + 1, device=dev), 2, 2, V)
    while not warm.done:
        warm.step(params, step_fn, mix_fn, params.embed)
    del warm

    batches = [new_batch(0)]
    win = ctx.open_window()
    gen_tokens = 0
    bare = {"flops": 0.0, "seconds": 0.0}
    laps = []
    now = win.t_open
    while now < win.t_close:
        b = batches[-1]
        if b.done:
            b = new_batch(len(batches))
            batches.append(b)
        counting = win.counting
        ctx_len = b.pos + 1
        n, t_lm, t_mix = b.step(params, step_fn, mix_fn, params.embed,
                                sync=ctx.sync if counting and ctx.on_card else None)
        gen_tokens += n
        if counting:
            laps.append({"decode_ms": 1e3 * t_lm,
                         "mix_ms": None if t_mix is None else 1e3 * t_mix})
        elif win.phase == 0:
            bare["flops"] += B * roofline.decode_flops_per_token(cfg, ctx_len)
        now = time.perf_counter()
        if win.phase == 0:
            bare["seconds"] = now - win.t_open
        win.tick(now)
    ctx.sync()
    t_end = time.perf_counter()
    win.close(t_end)
    rate = gen_tokens / (t_end - win.t_open)
    peak = ctx.memory_peak()
    while not batches[-1].done:                 # serve the requests in flight to their end
        batches[-1].step(params, step_fn, mix_fn, params.embed)
    ctx.sync()
    sources = {"counts": {"laps": laps, "bare": bare}}
    if ctx.trace:
        fed = batches[0].out[-8:]          # served tokens as retrieval queries

        def replay(meter):
            for t in fed:
                store.retrieve(params.embed[t.long()].float(), _scorer=meter)
        sources["roofline"] = {"wide": frontier_roofline(replay, "frontier_wide", ctx.on_card)}

    served = [(b.prompt[b.rows], b.out.T[b.rows], b.first, b.mixed.transpose(0, 1))
              for b in batches]
    del batches, store, step_fn, mix_fn, params
    free_device(ctx.on_card)
    nums = check(W, cfg, keys, torch.from_numpy(values).to(dev), served)
    checks = [Check(name, nums[name], cfg["check_limits"][name])
              for name in ("lm_logit_err", "mixed_logit_err", "served_gap")]
    if ctx.control:     # the plain forward with TF32 products in the program's place
        sources["control"] = check(W, cfg, keys, torch.from_numpy(values).to(dev), served,
                                   tf32=True)
    return Outcome(e2e={"decode_tokens_per_s": rate}, checks=checks,
                   attempted=B * len(served), failed=0, memory_peak_bytes=peak, sources=sources)


def check(W: dict, cfg: dict, keys, values, served, *, tf32: bool = False) -> dict:
    """Hold the served sequences to the plain reference.  ``served``:
    (prompts [R, P], served tokens [R, 1 + G], the logits at the last
    prompt position [R, V], the mixed logits of every mixed step [R, G,
    V]) per batch.  Returns the widest ``lm_logit_err`` (|program - plain|
    over the logits that chose the first token), ``mixed_logit_err``
    (|program - plain| over every mixed logit) and ``served_gap`` (how far
    the served token's plain logit lies below the plain best, at every
    served position).  With ``tf32`` the reference's lower precision
    stands in the program's place, its own argmax read for the gap."""
    from perfbench.reference import knnlm, starcoder2
    V, lam = cfg["vocab_size"], cfg["lam"]
    keys64 = keys.double()
    lm_err = mix_err = gap = 0.0
    for prompts, toks, first, mixed in served:
        for r in range(prompts.shape[0]):
            seq = torch.cat([prompts[r], toks[r, :-1]])          # every fed token
            P = prompts.shape[1]
            ref = starcoder2.logits(W, cfg, seq)[P - 1:]          # [1 + G, V]
            main, alt, amb = knnlm.knn_logp(keys64, values, W["embed"][toks[r, :-1].long()],
                                            cfg, V)
            ref_mixed = knnlm.mix(ref[1:], main, lam)             # [G, V] f64
            alt_mixed = knnlm.mix(ref[1:], alt, lam)
            if tf32:
                low = starcoder2.logits(W, cfg, seq, tf32=True)[P - 1:]
                got_first, got_mixed = low[0], knnlm.mix(low[1:], main, lam).float()
                served_tok = torch.cat([got_first.argmax()[None], got_mixed.argmax(-1)])
            else:
                got_first, got_mixed, served_tok = first[r], mixed[r], toks[r]
            lm_err = max(lm_err, (got_first.double() - ref[0].double()).abs().max().item())
            e_main = (got_mixed.double() - ref_mixed).abs().amax(-1)
            e_alt = (got_mixed.double() - alt_mixed).abs().amax(-1)
            e = torch.where(amb, torch.minimum(e_main, e_alt), e_main)
            mix_err = max(mix_err, e.max().item())
            g0 = (ref[0].max() - ref[0][served_tok[0].long()]).item()
            pick = served_tok[1:, None].long()
            gi = ref_mixed.max(-1).values - ref_mixed.gather(1, pick)[:, 0]
            gi_alt = alt_mixed.max(-1).values - alt_mixed.gather(1, pick)[:, 0]
            gap = max(gap, g0, torch.where(amb, torch.minimum(gi, gi_alt), gi).max().item())
    return {"lm_logit_err": lm_err, "mixed_logit_err": mix_err, "served_gap": gap}
