"""The cases of ``tests/test_torch_sharded_families.py`` and what each of
its four gloo ranks runs (``run_rank``): no JAX here, so the rank
processes start quickly.

Each case is a smoke config of a family whose tensor-parallel runtime is
the Mamba, xLSTM, encoder-decoder or vision-stub one, on a mesh of the
world's four ranks.  ``xlstm_tp_gt_h`` has fewer heads (2) than the model
axis has ranks (4), so each head spans two ranks; ``whisper_6h`` has six
heads, which the model axis of 4 does not divide, so the table replicates
``wq`` and the attention runs whole on every rank.
"""
import dataclasses
import json
import sys

import numpy as np

CASES = {
    "jamba": dict(arch="jamba-v0.1-52b", over={}, mesh=(2, 2)),
    "xlstm": dict(arch="xlstm-1.3b", over={}, mesh=(2, 2)),
    "xlstm_tp_gt_h": dict(arch="xlstm-1.3b", over={"n_heads": 2, "n_kv_heads": 2},
                          mesh=(1, 4)),
    "whisper": dict(arch="whisper-tiny", over={}, mesh=(2, 2)),
    "whisper_6h": dict(arch="whisper-tiny", over={"n_heads": 6, "n_kv_heads": 6},
                       mesh=(1, 4)),
    "internvl2": dict(arch="internvl2-1b", over={}, mesh=(2, 2)),
}
LAUNCH_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b", "whisper-tiny", "internvl2-1b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B = 4                  # rows of every batch
S = 16                 # decoder-only tokens a row
N_IMG_TEXT = 8         # internvl2: tokens after its 16 image positions
ENC, DEC = 24, 8       # whisper: frames and decoder tokens a row
DECODE_LEN = 8         # the decoder-only caches' positions
DECODE_STEPS = 2
SERVE = ["--smoke", "--knn", "--device", "cpu", "--prompt-len", "7", "--steps", "4"]
TRAIN = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "32", "--global-batch", "4"]


def config(name: str, smoke_config):
    c = CASES[name]
    return dataclasses.replace(smoke_config(c["arch"]), **c["over"])


def batch(cfg, seed: int) -> dict:
    """The case's training batch (the prefill takes it without labels)."""
    rng = np.random.default_rng(seed)
    toks = lambda n: rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32),
                "tokens": toks(DEC), "labels": toks(DEC)}
    if cfg.frontend == "vision_stub":
        n = cfg.n_image_tokens
        return {"tokens": toks(N_IMG_TEXT),
                "image_embeds": rng.standard_normal((B, n, cfg.d_model)).astype(np.float32),
                "labels": toks(N_IMG_TEXT + n)}
    return {"tokens": toks(S), "labels": toks(S)}


def fed(cfg) -> np.ndarray:
    """The decode tests' tokens, one column a step: seeded random ones, so
    every position's key and value differ."""
    return np.random.default_rng(9).integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)


def decode_len(cfg) -> int:
    """The decode cache's length: the encoder's frames for whisper."""
    return ENC if cfg.is_encdec else DECODE_LEN


def flat_tree(tree, prefix=""):
    """A reference-shaped tree as {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in
                flat_tree(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in
                flat_tree(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def unflat_tree(flat):
    """The inverse of ``flat_tree`` (lists where the keys are positions)."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def run_rank(rank: int, init: str, d: str) -> None:
    """One rank: every case's train step, local-shard checks, checkpoints
    both ways, prefill and decode logits, then ``launch/serve`` and
    ``launch/train --mesh host`` of each family; writes ``out.<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.parallel import ShardedLM
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import (from_reference_tree, params_from_jax,
                                            reference_layout, to_reference_tree)
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train import optimizer as TO
    from repro_torch.train import train_step as TT

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    plan = json.load(open(f"{d}/plan.json"))
    res = {}
    try:
        meshes = {m: make_host_mesh(*m, device="cpu") for m in {(2, 2), (1, 4)}}
        for name in plan["cases"]:
            cfg = config(name, smoke_config)
            mesh = meshes[CASES[name]["mesh"]]
            init_flat = dict(np.load(f"{d}/init_{name}.npz"))
            init_tree = unflat_tree(init_flat)
            bt = {k: torch.from_numpy(v) for k, v in batch(cfg, 3).items()}
            layout = reference_layout(M.param_specs(cfg), cfg)
            model = params_from_jax(init_tree, cfg, device="cpu")

            # serving: the prefill and two decode steps on the initial weights
            params = ShardedLM.from_model(model, cfg, mesh)
            data, mgroup = mesh.get_group("data"), mesh.get_group("model")
            inputs = {k: v for k, v in bt.items() if k != "labels"}
            pf, psh = make_prefill_step(cfg, mesh, ShapeSpec("p", S, B, "prefill"))
            lg = pf(params, inputs)
            if params._head_sharded():
                lg = all_gather(lg, 2, mgroup)
            res[f"{name}:prefill"] = all_gather(lg, 0, data).numpy() if psh["batch"][
                "tokens"][0] is not None else lg.numpy()
            fn, sh = make_decode_step(cfg, mesh, ShapeSpec("d", decode_len(cfg), B, "decode"))
            rows = shd.local_slices(sh["token"], (B,), mesh)[0]
            cache = params.init_cache(B, decode_len(cfg), sh["cache"])
            if cfg.is_encdec:
                cache = params.prefill_cache(bt["frames"][rows], cache)
            res[f"{name}:cache_shapes"] = np.asarray(json.dumps(
                shd._map_specs(lambda s, t: list(t.shape), sh["cache"], cache)))
            toks = torch.from_numpy(fed(cfg))
            for pos in range(DECODE_STEPS):
                _, logits, cache = fn(params, toks[rows, pos], cache, pos)
                if sh["token"][0] is not None:
                    logits = all_gather(logits, 0, data)
                res[f"{name}:decode_{pos}"] = logits.numpy()

            # one train step, without and (the attention-only decoders) with
            # sequence parallelism
            for tag, kw in [("step", {})] + ([("sp", dict(seq_parallel=True))]
                                             if set(cfg.block_pattern) == {"attn"}
                                             and not cfg.is_encdec else []):
                # a model of its own: the step updates the tensors that a
                # rank's shards share with it (those the table replicates)
                params = ShardedLM.from_model(params_from_jax(init_tree, cfg, device="cpu"),
                                              cfg, mesh, requires_grad=True)
                first = {n: t.detach().clone() for n, t in params.named_parameters()}
                opt = TT.init_sharded_opt(params, cfg, mesh)
                settings = TT.TrainSettings(opt=TO.AdamWConfig(**OPT), **kw)
                step, tsh = TT.make_train_step(cfg, mesh, bt, settings)
                params, opt, m = step(params, opt, bt)
                for k in ("loss", "grad_norm", "lr"):
                    res[f"{name}:{tag}_{k}"] = m[k].numpy()
                res[f"{name}:{tag}_used_sp"] = np.asarray(params.sp)
                full = params.gather()
                if rank == 0:
                    for k, v in flat_tree(to_reference_tree(full, layout)).items():
                        res[f"{name}:{tag}:{k}"] = v
                if tag != "step":
                    continue
                # the local shards: the table's slices of the gathered state
                # after the step, and of the whole initial tree before it
                bad = [n for n, t in params.named_parameters()
                       if not torch.equal(t.detach(), full[n][shd.local_slices(
                           params.specs[n], full[n].shape, mesh)])]
                tt = unflat_tree({k: torch.from_numpy(v) for k, v in init_flat.items()})
                shards = from_reference_tree(shd.shard_tree(
                    tt, shd.param_pspecs(cfg, M.param_specs(cfg), mesh), mesh), layout)
                bad += [n for n, t in first.items() if not torch.equal(t, shards[n])]
                res[f"{name}:bad_shards"] = np.asarray(len(bad))
                res[f"{name}:n_split"] = np.asarray(sum(
                    t.numel() < full[n].numel() for n, t in params.named_parameters()))
                # a checkpoint from the mesh (gathered to rank 0's host) ...
                state = TT.gather_state(params, opt, cfg, mesh)
                if rank == 0:
                    save_checkpoint(f"{d}/ck_port_{name}", 1,
                                    {"params": to_reference_tree(state[0], layout)})
                dist.barrier()
                # ... and the reference's checkpoint of the initial tree onto it
                blank = lambda node: ({k: blank(v) for k, v in node.items()}
                                      if isinstance(node, dict) else
                                      [blank(v) for v in node] if isinstance(node, list)
                                      else torch.empty(0))
                template = {"params": blank(shd.reference_shapes(M.param_specs(cfg), cfg))}
                out, manifest = restore_checkpoint(f"{d}/ck_ref_{name}", template,
                                                   shardings={"params": shd.to_named(
                                                       tsh["params"], mesh)})
                got = flat_tree(out["params"])
                specs = flat_specs(tsh["params"])
                res[f"{name}:restore_bad"] = np.asarray(sum(
                    not np.array_equal(v, init_flat[k][shd.local_slices(
                        specs[k], init_flat[k].shape, mesh)]) for k, v in got.items()))
                res[f"{name}:restore_n"] = np.asarray(len(got))

        # every arch: the runtime's shards of a model are the table's slices
        # of its reference tree (``shard_tree``)
        from repro_torch.configs import list_archs
        mesh = meshes[(2, 2)]
        for arch in list_archs():
            cfg = smoke_config(arch)
            model = M.init_params(cfg, 0, device="cpu")
            layout = reference_layout(model, cfg)
            tree = to_reference_tree({n: p.detach() for n, p in model.named_parameters()},
                                     layout)
            want = from_reference_tree(shd.shard_tree(
                tree, shd.param_pspecs(cfg, model, mesh), mesh), layout)
            params = ShardedLM.from_model(model, cfg, mesh)
            res[f"every:{arch}:bad"] = np.asarray(sum(
                not torch.equal(t, want[n]) for n, t in params.named_parameters()))
            res[f"every:{arch}:n_split"] = np.asarray(len(params._split_names))

        # the entry points, on the world's (2, 2) mesh
        for arch in LAUNCH_ARCHS:
            res[f"serve:{arch}"] = serve.main(SERVE + ["--arch", arch, "--mesh", "host"])
            res[f"train:{arch}"] = np.asarray(train.main(TRAIN + ["--arch", arch]))
        np.savez(f"{d}/out.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    print("RANK_DONE", rank)


def flat_specs(specs, prefix=""):
    """A spec tree (``sharding.Spec`` leaves) as {"a/b/0/c": spec}."""
    from repro_torch.dist.sharding import Spec
    if isinstance(specs, Spec):
        return {prefix[:-1]: specs}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    return {k2: v2 for k, v in items for k2, v2 in flat_specs(v, f"{prefix}{k}/").items()}


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
