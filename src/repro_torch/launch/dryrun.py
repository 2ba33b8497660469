"""Dry run of every (arch x shape x mesh) cell on the production mesh of
H100s (port of ``repro/launch/dryrun.py``): per device, the static bytes
(parameters, optimizer moments, decode cache), the FLOPs, bytes and
collective bytes of one rank's step, and the three-term roofline.

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
    python -m repro_torch.launch.dryrun --list

Records: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` (``--out``
names another directory).

How a cell runs.  No 256-rank process group can exist on one machine, so a
fake one stands for the other ranks: torch's ``fake`` backend, whose
collectives return at once and write nothing.  This process is rank 0 of
it; over it a ('data', 'model') ``DeviceMesh`` of the production shape
(16 x 16; the two-pod mesh with 'pod' folded into 'data', 32 x 16, as
``launch/mesh.py:dp_axes`` folds it), and rank 0's real train, prefill or
decode step runs on meta tensors through the code the card runs
(``dist/parallel.py:ShardedLM``, ``dist/tp.py``, the mesh forms of
``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``) under
``roofline/counts.py:OpCounts``.  Nothing is allocated or computed; the
kernels' entry points count their kernels by formula.  Static bytes come
from the rule table's specs on the production ``AbstractMesh`` itself
(three axes for the two-pod mesh): ``param_pspecs``, ``opt_state_pspec``,
``cache_pspecs``.

The record keeps the reference's fields (``status``, ``reason``,
``static_memory``, ``collectives``, ``roofline``, ``params``,
``active_params``); ``trace_s`` stands where ``lower_s`` / ``compile_s``
stood.  It has no ``memory_analysis`` and no ``hlo_*`` fields: there is no
compiled program to ask.  Attention is counted as the flash kernel the
card runs, not as the reference's XLA attention (``attn_impl="xla"``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import SHAPES, ShapeSpec, get_config, list_archs, shape_applicable
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.counts import OpCounts, extrapolate, top_contributors

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
# steps of a per-token loop traced (then m + 1, and extrapolated)
LOOP_STEPS = 2


def static_bytes_per_device(tree, pspecs, mesh, itemsize: int | None = None) -> int:
    """Exact per-device bytes of a sharded tree (params / opt / cache):
    ``tree``'s leaves (anything with ``shape`` and ``dtype``) split as
    ``pspecs`` (the same structure of ``Spec``s) over ``mesh``'s axes;
    ``itemsize`` overrides the leaves' dtype."""
    sizes = shd._mesh_sizes(mesh)
    total = [0]

    def leaf(spec, t):
        n = math.prod(t.shape)
        denom = math.prod(sizes[a] for e in spec for a in shd._axes_of(e))
        total[0] += -(-n // denom) * (itemsize or t.dtype.itemsize)

    shd._map_specs(leaf, pspecs, tree)
    return total[0]


def _bf16(cfg):
    """Production numerics + TP-friendliness padding for the 16-way mesh."""
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
                               head_pad=16, vocab_pad_to=256)


def program_shape(mesh: AbstractMesh) -> tuple[int, int]:
    """(data, model) of the one-rank program's mesh: 'pod' folded into
    'data'."""
    sizes = shd._mesh_sizes(mesh)
    return math.prod(sizes[a] for a in sizes if a != "model"), sizes.get("model", 1)


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A default process group of ``n_ranks`` ranks (torch's ``fake``
    backend: collectives return at once and write nothing), this process
    rank 0; destroyed at the end."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(data: int, model: int):
    """A ('data', 'model') ``DeviceMesh`` over the current process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (data, model), mesh_dim_names=("data", "model"))


def _decode_pos(cfg, shape: ShapeSpec) -> int:
    """The position one decode step writes: the last slot of the cache."""
    return (cfg.max_target_len if cfg.is_encdec else shape.seq_len) - 1


def _inputs(cfg, shape: ShapeSpec, device, seed: int = 0) -> dict:
    """The cell's inputs: ``input_specs`` on meta, seeded random ones
    elsewhere (tokens in the vocabulary, f32 frames / image embeddings)."""
    specs = M.input_specs(cfg, shape)
    if torch.device(device).type == "meta":
        return specs
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen, device=device,
                              dtype=v.dtype) if not v.dtype.is_floating_point
                else torch.randn(v.shape, generator=gen, device=device))
            for k, v in specs.items()}


def static_memory(cfg, shape: ShapeSpec, mesh) -> dict:
    """Per-device bytes of the cell's parameters, and of its optimizer's two
    f32 moments (train) or its decode cache (decode), from the rule table's
    specs on ``mesh`` (``param_pspecs``, ``opt_state_pspec``,
    ``cache_pspecs``)."""
    meta = M.param_specs(cfg)
    pspecs = shd.param_pspecs(cfg, meta, mesh)
    ref_shapes = shd.reference_shapes(meta, cfg)
    static = {"params_bytes_dev": static_bytes_per_device(ref_shapes, pspecs, mesh)}
    if shape.kind == "train":
        ospecs = shd._map_specs(lambda s, t: shd.opt_state_pspec(s, t.shape, mesh),
                                pspecs, ref_shapes)
        static["opt_bytes_dev"] = 2 * static_bytes_per_device(ref_shapes, ospecs, mesh,
                                                              itemsize=4)
    elif shape.kind == "decode":
        cache = M.cache_specs(cfg, shape)
        cspecs = (shd.cache_pspecs if cfg.is_encdec else shd.layer_cache_specs)(
            cfg, cache, mesh, seq_shard=shape.name == "long_500k")
        static["cache_bytes_dev"] = static_bytes_per_device(cache, cspecs, mesh)
    return static


def build_cell(cfg, shape: ShapeSpec, mesh: AbstractMesh, dmesh, *, ts_extra=None,
               device="meta"):
    """-> (step thunk, static bytes dict) of a cell.  ``mesh``: the
    production mesh the static bytes are counted on (``static_memory``);
    ``dmesh``: the ('data', 'model') ``DeviceMesh`` this rank's program
    runs on (over the current process group); ``device``: meta for the dry
    run, or a real device (seeded weights and inputs).  Each thunk call
    builds the state afresh and returns the step."""
    from repro_torch.dist.parallel import ShardedLM
    static = static_memory(cfg, shape, mesh)
    on_meta = torch.device(device).type == "meta"

    def model():
        return M.param_specs(cfg) if on_meta else M.init_params(cfg, 0, device=device)

    inputs = _inputs(cfg, shape, device)
    if shape.kind == "train":
        from repro_torch.train.train_step import TrainSettings, init_sharded_opt, make_train_step
        step_fn, _ = make_train_step(cfg, dmesh, inputs, TrainSettings(**(ts_extra or {})))

        def run():
            params = ShardedLM.from_model(model(), cfg, dmesh, requires_grad=True)
            opt = init_sharded_opt(params, cfg, dmesh)
            return lambda: step_fn(params, opt, inputs)
        return run, static

    if shape.kind == "prefill":
        from repro_torch.serve.serve_step import make_prefill_step
        fn, _ = make_prefill_step(cfg, dmesh, shape)

        def run():
            params = ShardedLM.from_model(model(), cfg, dmesh)
            return lambda: fn(params, inputs)
        return run, static

    from repro_torch.serve.serve_step import ServeSettings, make_decode_step
    fn, sh = make_decode_step(cfg, dmesh, shape,
                              ServeSettings(seq_shard_cache=shape.name == "long_500k"))
    pos = _decode_pos(cfg, shape)

    def run():
        params = ShardedLM.from_model(model(), cfg, dmesh)
        local = params.init_cache(shape.global_batch, M.cache_length(cfg, shape), sh["cache"])
        tok = inputs["token"][shd.local_slices(sh["token"], inputs["token"].shape, dmesh)]
        return lambda: fn(params, tok, local, pos)
    return run, static


def count_step(run, *, loop_steps: int | None = LOOP_STEPS) -> tuple[dict, dict]:
    """Trace one step (``run()`` builds the state and returns the step)
    under ``OpCounts``: -> (totals, the table of ops).  A step whose
    per-token loops were cut to ``loop_steps`` steps is traced again with
    one more and both extrapolated to the loops' trip count."""
    step = run()
    rec = OpCounts(loop_steps=loop_steps)
    with rec:
        step()
    totals, ops = rec.totals(), rec.ops
    if rec.trips:
        if len(rec.trips) > 1:
            raise ValueError(f"per-token loops of different trip counts: {sorted(rec.trips)}")
        (n,) = rec.trips
        step = run()
        rec2 = OpCounts(loop_steps=loop_steps + 1)
        with rec2:
            step()
        totals = extrapolate(totals, rec2.totals(), loop_steps, n)
        ops = extrapolate(ops, rec2.ops, loop_steps, n)
        totals["loop_trips"] = {"trips": n, "traced": [loop_steps, loop_steps + 1]}
    return totals, ops


def roofline(totals: dict, *, n_chips: int, model_flops_global: float, dtype: str) -> dict:
    coll = {"per_op_bytes": totals["collectives"], "counts": totals["collective_counts"],
            "total_bytes": totals["collective_bytes"], "by_link": totals["by_link"]}
    roof = RA.analyse({"flops": totals["flops"], "bytes accessed": totals["bytes"]}, coll,
                      n_chips=n_chips, model_flops_global=model_flops_global, dtype=dtype)
    return {"collectives": coll, "roofline": roof.to_dict()}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, save: bool = True,
             verbose: bool = True, cfg_extra=None, ts_extra=None, tag: str = "",
             shape: ShapeSpec | None = None, mesh: AbstractMesh | None = None,
             out_dir: Path | None = None, smoke: bool = False) -> dict:
    """One cell's record.  ``shape`` / ``mesh`` replace the named shape
    and the production mesh (a cell of one's own: ``shape_name`` and
    ``mesh_kind`` then only name it); ``smoke`` takes the arch's reduced
    config."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    n_chips = math.prod(shd._mesh_sizes(mesh).values())
    data, model = program_shape(mesh)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "n_chips": n_chips,
                    "tag": tag, "mesh_shape": dict(shd._mesh_sizes(mesh)),
                    "program_mesh": {"data": data, "model": model},
                    "cell": dataclasses.asdict(shape)}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
    else:
        try:
            built = _bf16(cfg)
            if cfg_extra:
                built = dataclasses.replace(built, **cfg_extra)
            t0 = time.time()
            with fake_world(n_chips):
                run, static = build_cell(built, shape, mesh, device_mesh(data, model),
                                         ts_extra=ts_extra)
                totals, ops = count_step(run)
            trace_s = time.time() - t0
            static["total_bytes_dev"] = sum(static.values())
            mf = RA.model_flops(cfg, shape)
            record.update(status="ok", trace_s=round(trace_s, 2), static_memory=static,
                          **roofline(totals, n_chips=n_chips, model_flops_global=mf,
                                     dtype=built.compute_dtype),
                          counts=totals, top_contributors=top_contributors(ops),
                          compute_dtype=built.compute_dtype,
                          params=M.exact_param_count(cfg),
                          active_params=cfg.active_param_count)
        except Exception as e:      # a cell's failure is its record's; the sweep goes on
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-4000:])
    if verbose:
        print(summary_line(record), flush=True)
    if save:
        d = Path(out_dir or ART_DIR)
        d.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
        (d / f"{name}.json").write_text(json.dumps(record, indent=1))
    return record


def summary_line(record: dict) -> str:
    s = record["status"]
    extra = ""
    if s == "ok":
        r = record["roofline"]
        extra = (f" bottleneck={r['bottleneck']} compute={r['compute_s']:.4g}s "
                 f"memory={r['memory_s']:.4g}s collective={r['collective_s']:.4g}s "
                 f"frac={r['roofline_frac']:.3f} "
                 f"static={record['static_memory']['total_bytes_dev'] / 1e9:.2f}GB/80GB "
                 f"trace={record['trace_s']}s")
    elif s == "error":
        extra = " " + record["error"][:160]
    tag = f" #{record['tag']}" if record.get("tag") else ""
    return f"[dryrun] {record['arch']} x {record['shape']} x {record['mesh']}{tag}: {s}{extra}"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None, help=f"record directory (default {ART_DIR})")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            for s in SHAPES:
                print(a, s)
        return []

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out) if args.out else ART_DIR
    records = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
                if args.skip_existing and path.exists():
                    if json.loads(path.read_text()).get("status") in ("ok", "skipped"):
                        continue
                records.append(run_cell(arch, shape_name, mesh_kind, out_dir=out_dir))
    failures = sum(r["status"] == "error" for r in records)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    return records


if __name__ == "__main__":
    main()
