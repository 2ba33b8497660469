#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; it exits non-zero without them.  It imports only
``repro_torch`` (from ``src/`` beside this file), torch, numpy and the
standard library, and prints one JSON line per phase.

The index slice (``run``):

  1. device: the card's name, the device count and nvidia-smi's name and
     power limit;
  2. build: nvcc build seconds of every source and its -Xptxas -v summary
     (instantiations, registers and spilled bytes of each kernel);
  3. each kernel against its plain PyTorch version at the main path's
     shapes (frontier scorer: bitwise for d_inf/l2/l1, filter off and on;
     distance scan: d_inf bitwise, sqeuclidean/ip within 1e-5, at the
     index path's 256 x 1,000,000 x 20 and at 1024 x 65,536 x 20), with
     CUDA-event times of the kernel, the plain version and the library
     call that computes the same function, where there is one, and the
     kernel's device time (``device_ms``);
  4. the main path at full size: 1,000,000 clustered 20-d objects, bulk
     build, kNN at the bench geometry (k=10, max_frontier=64, b=1024) and at
     the smallest exact geometry (max_frontier 2048..16384, b=256) held
     bitwise against the kernel-backed brute-force scan, the device time
     of one cohort by kernel (torch.profiler), range search held against
     the scan;
  5. Insert/Delete with leaf splits and merges, validate(), and the exact
     kNN check again against a scan of the updated set;
  then the kernel launch counts of that main path (phases 4-5, counters
  zeroed just before), and, outside the count,
  5b. frontier_replay_index: the frontiers that one cohort passed to the
     scorer at the bench and the exact geometry (captured through the
     plain scorer in phase 4), replayed level by level through the narrow
     kernel as phase 12 does for the wide one;
  5c. device_split_merge: a cohort of about 8,192 rows on the updated
     index (inserts of new ids piled on every leaf under consecutive
     level-1 nodes, deletes thinning leaves below min_fill, beside
     thinned siblings and beside full ones), growing the node table first
     if ``needs_headroom`` says so: one clone through
     ``apply_mutations`` with the device split and merge passes, another
     through the fast scan and the host plane (``escalate_rows``), held
     bitwise (statuses with ST_SPLIT/ST_MERGE read as ST_APPLIED, all 16
     fields), validate(), the exact kNN check against a scan of the live
     set; the seconds of the fast scan, of each pass (ms per row) and of
     the host plane;
  6. the cohort descent through the kernels against the same descent
     through the plain scorer, bitwise (all five result fields and the
     level-stat stacks), on the d_inf tree and on 100k-object l2/l1 trees.

The SM-forest pass (``run_forest``), launch counters zeroed just before
and read just after, so that the index slice's counts stay comparable:

  F1. forest_build: the same 1,000,000 objects round robin over 8 shards,
      capacity 32, stacked on the card: seconds, each shard's height and
      node count, device bytes;
  F2. forest_knn_bench / forest_knn_exact: ``forest_knn`` (each shard's
      cohort descent through the narrow kernel, then the k-way merge) at
      the bench geometry and at the smallest exact max_frontier, each held
      bitwise against the same forest through the plain scorer (and every
      shard's five fields at the bench geometry); the exact result held
      against the sharded scan (the group form of ``brute_force_knn``
      with its 8 ranks' slices scanned one after another on the card,
      itself equal to the one-device scan); ms per cohort, the scan's ms,
      and the device time by kernel (torch.profiler);
  F3. forest_perquery: the per-query engine on shard 0 at both geometries
      with both engines' ms, held against the cohort engine at the exact
      geometry (dists on rows neither overflowed, ids where a row's
      distances are distinct; at the bench geometry every row of both
      engines overflows, so there it is timed only);
  F4. forest_mutations: 2,048 inserts of new ids and 2,048 deletes, owner
      routed, through ``forest_apply_mutations``, statuses and every
      field bitwise against the same log one row at a time through
      ``insert_fast``/``delete_fast``; then the same log, from the same
      shards, through both planes of ``StreamingForest`` (``stream_planes``):
      the stacked plane (the scan front, the overflow rows through
      ``forest_apply_splits`` in ``split_chunks`` widths, the underflow rows
      through ``forest_apply_merges`` in ``merge_chunks`` widths) and the
      host plane (per-shard batchers), statuses and shards held bitwise
      between them, and the rows left to the host plane;
      ``forest_extract_objects`` of 256 live ids against their stored rows;
      the exact kNN check again against a scan of the live set; then the
      pass's launch counts.

The kNN-LM serving slice (``run_lm``), qwen2.5-3b at full width in f32:

  7. kernel_frontier_wide: the frontier scorer's wide-row variant bitwise
     against the plain version at b=64, F=128, cap=32, dim 2048/896/1023/
     4096, d_inf/l2/l1, filter off and on, timed at the served key widths
     2048 (the rows' ms and bound) and 4096 (jamba's; the rows' ``by_dim``);
  8. kernel_flash: the flash kernel against ``flash_attention_torch`` at
     the prefill shape [4, 16, 2048, 128] causal (f32 within 2e-4, bf16
     within 1e-2), at GQA g=8 with sq != sk, causal and not, and at
     whisper-tiny's three shapes (phase L4's b=16, 6 heads of 64: the
     encoder's [1500 x 1500] non-causal, the decoder's [448 x 448] causal,
     the cross-attention's [448 x 1500] non-causal; the flash row's
     ``by_shape``); times of the kernel, the plain version and SDPA (the
     library call, where sq == sk or the mask is off),
     and the bound at the arithmetic the kernel uses (three TF32 tensor-core
     products per f32 product, one bf16 product in bf16), beside the f32
     CUDA-core bound (``f32_cuda_core_bound_ms``);
  9. kernel_distance_prune: the distance kernel's prune epilogue against
     its plain version at nq=1024, ne=65,536, d=20, with its device time;
  then the slice's main path, launch counters zeroed just before:
  10. lm_serve: random weights from a seeded generator on the card, one
      prefill forward at b=4, s=2048 through the flash kernel (36 launches)
      held against the same forward through the plain attention, with the
      flash kernel's share of that forward's device time, and the
      ``launch/serve`` loop (b=4, prompt 32, 16 greedy steps) mixing a
      2048-key kNN-LM store; profile_lm: device time by kernel of one
      prefill and one kNN-LM decode step;
  11. knnlm_datastore: 65,536 keys tapped from the model's final hidden
      states (32 x 2048 synthetic tokens), bulk build, retrieval at b=4
      and b=64 (k=8, F=128) with the kernel descent held bitwise against
      the plain-scorer descent, evict_before(64) through Delete (cut from
      1,024 to keep the run under ~560 s; the batched paths keep 1,024),
      validate(), and the bitwise check again; then the slice's launch
      counts;
  and, outside the counts,
  11b. knnlm_batched_evict: the same 1,024 deletes as one cohort through
      ``apply_mutations`` with the device passes, on a copy of the store's
      tree taken before ``evict_before`` (the wide-row l2 split/merge path;
      not bitwise to ``evict_before``'s tree, since a cohort orders its
      structure edits differently from one Delete at a time): seconds,
      merges and redistributions beside ``evict_before``'s seconds,
      validate(), the live ids equal to the evicted store's, retrieval at
      b=4 and b=64 with the kernel descent bitwise to the plain one;
  12. frontier_replay: the frontiers that the descent passed to the scorer
      in the first retrieval at b=4 and b=64 (captured through the plain
      scorer), replayed level by level through the wide kernel, bitwise
      against the plain version: ms (CUDA events around back-to-back
      calls, host overhead included), device ms (CUDA events around calls
      queued behind a spin kernel, so that they run back to back on the
      card: ``device_ms``), live evaluations, pairs, distinct nodes and
      bound for each level and summed over a retrieval.

The stream path (``run_stream``), launch counters zeroed just before and
read just after, apart from the other paths':

  S1. stream_datastore: the phase-11 store (a copy taken before its
      eviction) through ``enable_stream`` with a WAL and checkpoints:
      ``evict_batch`` of the 1,024 ids phase 11 evicts (live ids: every id
      from 1,024 on), then ``add_batch`` of 1,024 new hidden states, each
      beside an epoch pinned before it whose ``tree_digest`` must not
      change; seconds per batch split into the ``mutation.wal_append``,
      ``mutation.apply`` (the per-batch copy included) and
      ``mutation.publish`` spans, the copy alone, rows escalated to the
      host plane, WAL bytes, device bytes of the resident epochs; the
      overflow share at b=64 by F (128 .. 8192); retrieval at b=4 and b=64
      on the pinned epoch, kernel descent bitwise to the plain one, with
      ``knn_logits`` ms; a snapshot, two more batches, then
      ``StreamingEngine.restore`` + the WAL tail and a ``Replica`` tailing
      the same WAL, each equal to the live engine's (seq, digest);
  S3. lm_serve_stream: ``launch/serve`` with ``--knn --knn-mutate --obs``
      and with ``--knn-shards 4`` on the phase-10 weights: ms per decode
      step beside phase 10's, the obs snapshot's stream/wal/epoch rows;
  S2. stream_forest: the 1,000,000 objects over 8 shards as a
      ``StreamingForest`` (incremental, max skew 1.3, 256 objects at
      least; WAL and checkpoints): 32,768 deletes of shard 0's ids in 8
      batches of 4,096, ``maintenance()`` after each, the first 2 batches
      through both planes held bitwise; 32 migration steps with a snapshot
      after the 16th, then restore + the WAL tail equal to the live forest
      (the crash drill); forest kNN on a pinned epoch at b=1024, F=64
      through the kernels bitwise to the plain scorer, and at the smallest
      exact F against ``brute_force_knn`` of the live set; ms per stream
      row, per migration step, the skew before and after; one
      stop-the-world rebuild on the side, timed.

The serving path (``run_serve``), counted the same way under
``launches_by_path.serve``; the launches of its checks (the ticket
re-runs, the plain-scorer cohort, R1's exact check, R3's live-forest
reference) are put back by ``uncounted()``:

  R1. serve_frontend: the index slice's 1M-object tree as a
      ``StreamingEngine`` behind the front-end, 64 closed-loop clients at
      cohort width 64 and 1 (QPS, p50/p99, mean fill), then the width-64
      drill while 4 batches of 512 rows (cut from 8) apply, every ticket
      re-run bitwise on the epoch it names, the wait behind a batch;
  R2. serve_replication: the WAL shipped over 127.0.0.1 under 5% drop and
      5% reorder to 2 replicas (catch-up, digest, bytes, lag), then the
      router's leader, replica and degraded reads;
  R3. serve_failover: the leader killed mid-batch, a replica promoted
      under a higher token, the deposed leader fenced out (failover ms);
      ``promote_follower`` on a forest follower restored from S2's
      snapshot and WAL, its kNN bitwise to the live forest's;
  R4. lm_serve_frontend: ``launch/serve --knn --knn-mutate --frontend
      --replicas 2 --obs`` on phase 10's weights: ms per decode step, the
      front-end's counters, the replicas' lag, the obs rows and
      ``fetch_metrics`` over the ship socket.

The block families (``run_lm_families``), after the serving path has let
qwen2.5-3b's weights and the datastores go, each phase counted apart under
``launches_by_path.lm_moe`` / ``lm_hybrid`` / ``lm_xlstm`` / ``lm_audio``,
each phase's weights let go before the next one's are drawn:

  L1. lm_moe: qwen2-moe-a2.7b at full width and depth in f32 (exactly
      14,315,735,040 parameters, seeded random weights): a prefill at b=4,
      s=2048 through ``make_prefill_step`` (24 flash launches), its aux
      (lb_loss, z_loss, drop_frac) and peak memory, held against the same
      prefill through the plain attention on the tokens whose routing
      agreed in every MoE layer (the share of routings that differ is
      printed and bounded by 1e-3; the kernel run's logits wait on the
      host, so one [4, 2048, 151936] tensor is on the card at a time);
      where its device time goes (one torch.profiler run: by kernel, and
      by layer kind from the blocks' ``block.<kind>`` ranges); then
      ``launch/serve --arch qwen2-moe-a2.7b --knn`` (b=4, prompt 32, 16
      steps, a 2048-key store of width 2048: the wide frontier kernel),
      and the served store's retrieval at b=4 against the plain-scorer
      descent, bitwise;
  L2. lm_hybrid: jamba-v0.1-52b at full width cut to one 8-layer period
      (13,295,235,072 parameters; all 32 layers are 206 GB in f32): the
      same prefill checks (1 flash launch, 8 chunks of the scan a Mamba
      layer), decode over a 64-token prompt against a forward made
      dropless like it (capacity factor E / k), then ``launch/serve --arch
      jamba-v0.1-52b --knn`` (keys of width 4096) with the same retrieval
      check;
  L3. lm_xlstm: xlstm-1.3b at full width and depth (48 layers, 42 mLSTM
      and 6 sLSTM, exactly 3,609,147,728 parameters): the same prefill
      checks (0 flash launches: no attention layer; the time by
      ``block.mlstm`` / ``block.slstm`` range), decode over a 64-token
      prompt at b=4 against the forward (chunk-parallel against
      recurrent), then ``launch/serve --arch xlstm-1.3b --knn`` (keys of
      width 2048) with the same retrieval check;
  L4. lm_audio: whisper-tiny at full size (4 + 4 layers, exactly
      36,620,160 parameters), seeded frames [16, 1500, 384] and decoder
      tokens [16, 448]: a forward through ``make_prefill_step`` (12 flash
      launches: 4 encoder, 4 decoder, 4 cross) held against the same
      forward through the plain attention, ``encdec_prefill_cache`` (4
      launches) and a cached decode of 64 tokens at b=16 against the
      forward's logits, then ``launch/serve --arch whisper-tiny --knn``
      (no encoder runs there, as in the reference; keys of width 384) with
      the same retrieval check.

The training path (``run_train``), after the families' weights are gone,
counted under ``launches_by_path.train``; the launches of its checks are
put back by ``uncounted()``:

  T1. train_full: qwen2.5-3b at full width and depth in f32 (exactly
      3,085,938,688 parameters, seeded random weights that require grad,
      AdamW's two f32 moments; remat by layer), b=2 x 2048 tokens from
      ``synth_batch``.  Checks from the first state: a forward and
      backward through the flash kernel (36 launches in the forward, 36
      in remat's recompute) held against the same through the plain
      attention (loss within 1e-4, grad_norm within 1e-3, relative), and
      a second pass through the kernel equal to the first bitwise (loss
      and grad_norm).  Then a warm step, 3 timed steps (ms, tokens/s,
      peak memory, every loss and grad_norm finite and grad_norm > 0, 72
      flash launches a step) and one profiled step split into forward,
      backward (remat's recompute and the plain attention VJP) and
      optimizer (``profile_train``: busy ms and ``block.<kind>`` spans by
      phase, the idle share);
  T2. train_resume: ``launch/train.main`` on the card with the smoke
      qwen2.5-3b, 24 steps straight, then killed by ``--fail-at 13`` with
      ``--ckpt-every 8`` and resumed: the final losses equal bitwise; then
      ``compressed_mean_hook`` with error feedback over 3 batches of the
      smoke model's gradients, on the card and on the CPU, bitwise.

The mesh path (``run_mesh``), after the training path, on a process group
of one rank (NCCL; ``file://`` init in a temporary directory) and a (1, 1)
{data, model} mesh, counted under ``launches_by_path.mesh`` (one card:
NCCL across ranks is not exercised):

  M1. train_sharded: T1's model, seed, batches and optimizer through the
      mesh form of ``make_train_step`` (the rule table, ``ShardedLM``,
      ZeRO-1 moments), as many steps as T1: every loss and grad_norm
      bitwise T1's; ms a step, tokens/s, peak memory, the profiled step's
      idle share, 72 flash launches a step;
  M2. serve_sharded: ``launch/serve.serve_sharded`` with ``--knn`` (the
      mesh store) at qwen2.5-3b full width, b=4: its tokens bitwise
      lm_serve's (phase 10); ms a decode step and wide frontier launches a
      step; then the mesh decode step's logits at every one of its 48
      positions, fed seeded random tokens, bitwise the one-device decode
      step's on the same weights and inputs;
  M3. mesh_families: the other block families through the same mesh,
      each run held bitwise to the same run on one device (run inside
      ``uncounted()``): ``mesh_hybrid``, jamba-v0.1-52b's 8-layer period
      at full width (the mesh prefill at b=4, s=2048: logits; then
      ``serve_sharded --knn``: tokens; it does not train on the card, one
      period's training state being ~213 GB), ``mesh_xlstm``, xlstm-1.3b
      (all 48 layers through ``serve_sharded --knn``: tokens; 3 steps of
      one 8-layer period at b=2 x 2048, f32: losses and grad norms), and
      ``mesh_audio``, whisper-tiny (the forward at b=16 with 1,500 frames
      and 448 tokens: logits; the cross K/V from the frames and 64 cached
      decode steps: logits and tokens; 3 train steps: losses and grad
      norms); ms, tokens/s, peak GB, the idle share of one run
      (``device_busy``) and flash and wide launches by pass.

The dry-run path and the examples (``run_dryrun``), after the mesh path,
counted under ``launches_by_path.dryrun`` and ``.examples``:

  D1. dryrun: ``launch/dryrun.py``'s cells in a process of their own (each
      holds a fake default process group of the mesh's size; meta
      tensors, nothing on the card), started first and read last: one
      cell of every family on the 16 x 16 mesh, all ``ok``, each with its
      bottleneck, three terms and static GB per device beside 80; the
      long_500k cells of the eight full-attention archs ``skipped`` with
      the reference's reason; T1's cell at mesh (1, 1);
  D2. forest_dryrun: ``launch/forest_dryrun.py``'s reference cell (262,144
      objects, dim 64, 16 shards, b=256, k=8, F=64, l2) in another
      process: rank 0's step on the card through the narrow kernel,
      bitwise to the plain scorer, its device ms beside its three terms;
  E.  examples: the four examples on the card; ``quickstart`` and
      ``distributed_index`` print what their ``--device cpu`` runs print
      (every kNN distance, id and page hit), ``knnlm_serve`` runs through
      its ``validate()``, ``train_lm``'s resumed loss equals an
      uninterrupted run's, bitwise;
  D3. dryrun_vs_card: T1's static parameter and optimizer bytes against
      the growth of ``memory_allocated`` across ``init_all``; its meta
      FLOPs, bytes and collectives against one real step of the same mesh
      program on the card under the same recorder (one-rank NCCL group),
      equal; T1's measured ms a step against its bound and model FLOPs.

The last three lines are the ``kernels`` line (every TPU kernel's port,
the frontier scorer's wide rows in two rows of their own: launches on its
slice's main path and per pass of that path, ms, plain ms, bound ms,
library ms; ``launches_by_path`` gives every path's count apart: ``index``
and ``forest`` for the narrow rows and the scan, ``lm``, ``lm_moe``,
``lm_hybrid``, ``lm_xlstm`` and ``lm_audio`` for the LM rows, and
``stream``, ``serve``, ``train``, ``mesh``, ``dryrun`` and ``examples``
for all; the
distance scan at the index path's shape, with
its device ms and its synthetic-shape row),
nvidia-smi's name and power limit, and ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero and prints no
result line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

K = 10
BENCH_F = 64
EXACT_FS = (2048, 4096, 8192, 16384)
FULL = dict(n=1_000_000, dims=20, capacity=32, b_bench=1024, b_exact=256,
            b_parity=128, b_recheck=64, n_small=100_000, kernel_b=1024,
            kernel_F=64, kernel_N=50_000, dist_nq=1024, dist_ne=65_536,
            dist_path_nq=256, dist_path_ne=1_000_000,
            n_insert=300, sm_rows=8192, sm_min_rows=100, timing_reps=5)
# the SM-forest: the index slice's set round robin over 8 shards
FOREST_FULL = dict(n=1_000_000, dims=20, capacity=32, n_shards=8, b_bench=1024,
                   b_exact=256, exact_fs=(512, 1024, 2048, 4096, 8192, 16384),
                   n_insert=2048, n_delete=2048, n_extract=256, b_recheck=64,
                   timing_reps=5)
# the kNN-LM serving slice: qwen2.5-3b at full width (all 36 layers), f32
LM_FULL = dict(
    arch="qwen2.5-3b", smoke=False, prefill_b=4, prefill_s=2048,
    serve_argv=["--knn"],                 # b=4, prompt 32, 16 steps
    # ds_evict: the batched evictions' count (11b, S1); ds_evict_before:
    # phase 11's one-Delete-at-a-time evict_before, cut from 1,024 to 64
    # ids (~140 s to ~9 s; 256 took 34 s) to keep the whole run, the
    # model families' pass included, under ~560 s
    ds_seqs=32, ds_len=2048, ds_chunk=4, ds_evict=1024, ds_evict_before=64, ret_bs=(4, 64),
    # wide_dims: every one held bitwise; wide_timed: the served key widths
    # (qwen2.5-3b's and qwen2-moe's 2048, jamba's 4096), timed and bounded
    wide_b=64, wide_F=128, wide_cap=32, wide_N=4096, wide_dims=(2048, 896, 1023, 4096),
    wide_timed=(2048, 4096),
    flash_cases={                         # b, h, hk, sq, sk, d, causal, dtype
        "path_f32": (4, 16, 16, 2048, 2048, 128, True, "float32"),
        "path_bf16": (4, 16, 16, 2048, 2048, 128, True, "bfloat16"),
        "gqa8_sq<sk": (1, 16, 2, 512, 1024, 128, True, "float32"),
        "gqa8_noncausal_sq>sk": (2, 16, 2, 700, 300, 128, False, "float32"),
        "gqa8_bf16": (1, 16, 2, 512, 1024, 128, True, "bfloat16"),
        # whisper-tiny's three attentions (d_model 384, 6 heads of 64) at
        # phase L4's batch: the encoder over 1,500 frames, the decoder's
        # 448 positions, and the cross-attention onto the frames
        "whisper_encoder": (16, 6, 6, 1500, 1500, 64, False, "float32"),
        "whisper_decoder": (16, 6, 6, 448, 448, 64, True, "float32"),
        "whisper_cross": (16, 6, 6, 448, 1500, 64, False, "float32")},
    prune_nq=1024, prune_ne=65_536, prune_d=20, timing_reps=5)
# the block families (run_lm_families), f32, seeded random weights:
# qwen2-moe-a2.7b at full width and depth, jamba-v0.1-52b at full width cut
# to one 8-layer period (all 32 layers are 206 GB in f32), xlstm-1.3b at
# full width and depth, whisper-tiny at full size with 1,500 frames (the
# conv stub's output for a 30-s window) and 448 decoder positions;
# ``params`` pins each model's exact parameter count (the reference's
# ``exact_param_count``, held by tests/test_torch_models.py,
# test_torch_xlstm.py and test_torch_encdec.py)
LM_FAMILIES_FULL = dict(
    moe=dict(arch="qwen2-moe-a2.7b", smoke=False, overrides={}, params=14_315_735_040,
             prefill_b=4, prefill_s=2048, serve_argv=["--arch", "qwen2-moe-a2.7b", "--knn"]),
    hybrid=dict(arch="jamba-v0.1-52b", smoke=False, overrides={"n_layers": 8},
                params=13_295_235_072, prefill_b=4, prefill_s=2048, decode_b=4,
                decode_len=64, serve_argv=["--arch", "jamba-v0.1-52b", "--knn"]),
    xlstm=dict(arch="xlstm-1.3b", smoke=False, overrides={}, params=3_609_147_728,
               prefill_b=4, prefill_s=2048, decode_b=4, decode_len=64,
               serve_argv=["--arch", "xlstm-1.3b", "--knn"]),
    audio=dict(arch="whisper-tiny", smoke=False, overrides={}, params=36_620_160,
               prefill_b=16, frames=1500, prefill_s=448, decode_len=64,
               serve_argv=["--arch", "whisper-tiny", "--knn"]),
    max_flip_share=1e-3, timing_reps=2)
# the training path (run_train): T1 qwen2.5-3b at full width and depth in
# f32 (params, grads and both moments ~49.4 GB; b=2 x 2048 tokens, remat
# on; b=4 was worked out at ~72 GB), T2 the reference's kill/resume
# contract on the smoke model (tests/test_checkpoint.py's N, k and fail-at)
TRAIN_FULL = dict(
    full=dict(arch="qwen2.5-3b", smoke=False, params=3_085_938_688, b=2, s=2048,
              timed_steps=3, opt=dict(lr=3e-4, warmup_steps=2, total_steps=100),
              loss_rtol=1e-4, gnorm_rtol=1e-3, attn_tol=2e-4, reduced=[]),
    resume=dict(arch="qwen2.5-3b", steps=24, seq_len=32, global_batch=4, ckpt_every=8,
                fail_at=13, hook_steps=3))
# the mesh path (run_mesh) on a one-rank process group: M1 T1's model,
# batches and optimizer through the mesh form of make_train_step (every
# step of T1's, held bitwise); M2 serve_sharded with lm_serve's argv (b=4,
# prompt 32, 16 steps), its tokens held bitwise to lm_serve's, and the mesh
# decode step's logits held bitwise to the one-device decode step's
MESH_FULL = dict(train=dict(arch="qwen2.5-3b", smoke=False, b=2, s=2048,
                            opt=dict(lr=3e-4, warmup_steps=2, total_steps=100)),
                 serve_argv=["--knn"],
                 # M3: the other block families through the same mesh, each
                 # held bitwise to one device: jamba-v0.1-52b's 8-layer
                 # period (serving and the prefill; all 32 layers are 206
                 # GB in f32, and one period's training state ~213 GB, so it
                 # trains over gloo only), xlstm-1.3b at full depth served
                 # and one 8-layer period trained, whisper-tiny at full size
                 families=dict(
                     hybrid=dict(arch="jamba-v0.1-52b", smoke=False, overrides={"n_layers": 8},
                                 prefill_b=4, prefill_s=2048,
                                 serve_argv=["--arch", "jamba-v0.1-52b", "--knn"]),
                     xlstm=dict(arch="xlstm-1.3b", smoke=False, overrides={},
                                serve_argv=["--arch", "xlstm-1.3b", "--knn"],
                                train=dict(overrides={"n_layers": 8}, b=2, s=2048, steps=3,
                                           opt=dict(lr=3e-4, warmup_steps=2,
                                                    total_steps=100))),
                     audio=dict(arch="whisper-tiny", smoke=False, b=16, frames=1500,
                                tokens=448, decode_steps=64, train_steps=3,
                                opt=dict(lr=3e-4, warmup_steps=2, total_steps=100))))


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def timers(on_card: bool):
    """(sync, time_ms, wall) for the device of the run."""
    import torch

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
        """Mean ms per call: CUDA events over ``iters`` warm calls."""
        for _ in range(warmup):
            fn()
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    return sync, time_ms, wall


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(ms, what bounds it) at the H100's HBM rate and f32 CUDA-core peak
    (the constants of ``repro_torch.roofline.analysis``)."""
    from repro_torch.roofline.analysis import bound as h100_bound
    return h100_bound(nbytes, nops)


def flash_bound(nbytes: float, nops: float, dtype: str) -> tuple[float, str]:
    """The flash kernel's bound at the arithmetic it uses: three TF32
    products per f32 product (3xTF32), one bf16 product per bf16 one."""
    from repro_torch.roofline import analysis as RA
    if dtype == "float32":
        return RA.bound(nbytes, 3 * nops, RA.H100_TF32_FLOP_PER_S)
    return RA.bound(nbytes, nops, RA.H100_BF16_FLOP_PER_S)


def ptxas_summary(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` output for one source, by kernel: for each
    ``..._kernel`` named in the mangled entry functions, its instantiations,
    the least and most registers any of them uses, the spilled bytes
    (stores and loads) summed over them, and the template arguments of
    those that spill (``spilling``)."""
    import re
    out: dict = {}
    cur = args = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"([A-Za-z][A-Za-z_]*kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            cur = out.setdefault(k.group(1) if k else m.group(1),
                                 {"instances": 0, "registers": [], "spill_bytes": 0,
                                  "spilling": []})
            cur["instances"] += 1
            args = ("<" + ",".join(re.findall(r"L[ib](\d+)E", k.group(2))) + ">"
                    if k and k.group(2) else "")
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and int(m.group(1)) + int(m.group(2)):
                cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
                cur["spilling"].append(args)
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"].append(int(m.group(1)))
    for v in out.values():
        r = v["registers"]
        v["registers"] = [min(r), max(r)] if r else []
    return out


def frontier_traffic(fids, queries, want, cap: int, prune: bool):
    """(bytes, ops, live entries) of one frontier scoring on this data
    (``repro_torch.roofline.counts.frontier_work``, the formula the dry
    run counts): each referenced page's radius/validity (+pdist) rows and
    each live entry's vector read once, the four outputs written once; 3
    ops per dimension of a live entry and 4 per output slot."""
    from repro_torch.roofline.counts import frontier_work
    nops, nbytes = frontier_work(fids, queries, want, cap, prune)
    b, F = fids.shape
    return nbytes, nops, int(nops - 4 * b * F * cap) // (3 * queries.shape[1])


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: CUDA events around ``iters`` calls that
    the host enqueues while the stream still runs a ~50 ms spin kernel
    (``torch.cuda._sleep``), so that the calls run back to back on the card.  Free of the host's
    launch overhead, which plain back-to-back event timing of a small
    launch measures instead."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, wall_ms: float, on_card: bool = True) -> dict:
    """Device time of one ``fn()`` by kernel (torch.profiler): busy ms, the
    idle share of ``wall_ms``, the flash kernel's share, the top 8 kernels,
    and by layer kind (``blocks``: calls and summed device-side spans, first
    kernel's start to last kernel's end, of each ``block.<kind>`` range
    that the models open around a block's mixer and FFN; a span holds any
    idle gap inside it, and flash counts inside ``attn``).  The spans are
    kineto's device-side copies of the ranges: the host-side ranges'
    ``device_time_total`` counts some kernels under more than one op, so
    its sums can exceed the busy time.  Everything is read from kineto's
    raw events, not from ``key_averages()``, whose tree of host events
    took 137 s for the ~10^6 events of xlstm-1.3b's prefill.  Off the card
    only the host-side ranges' calls (span None)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if on_card:
            torch.cuda.synchronize()
    blocks, kern = {}, {}
    for ev in prof.profiler.kineto_results.events():
        name, dev = ev.name(), "cuda" if "CUDA" in str(ev.device_type()) else "cpu"
        if name.startswith("block."):
            if (dev == "cuda") == on_card:
                b = blocks.setdefault(name.removeprefix("block."),
                                      dict(span_ms=0.0 if on_card else None, calls=0))
                b["calls"] += 1
                if on_card:
                    b["span_ms"] += ev.duration_ns() / 1e6
        elif dev == "cuda" and not ev.is_user_annotation():
            k = kern.setdefault(name, [0.0, 0])
            k[0] += ev.duration_ns() / 1e6
            k[1] += 1
    if not on_card:
        return dict(blocks=blocks)
    top = sorted(kern.items(), key=lambda kv: kv[1][0], reverse=True)
    busy = sum(ms for ms, _ in kern.values())
    flash = sum(ms for name, (ms, _) in kern.items() if "flash_fwd_kernel" in name)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall_ms),
                flash_ms=flash, flash_share_of_busy=flash / busy if busy else 0.0,
                blocks=blocks,
                kernels=[dict(name=name[:72], ms=ms, calls=n) for name, (ms, n) in top[:8]])


def profile_decode_knn(params, mcfg, store, tokens, lam: float) -> dict:
    """``profile_device`` of one cached decode step at position 0 that
    mixes the store's kNN log-probs in, as ``launch/serve`` does."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.knnlm import mix_logits
    dev = params.embed.device
    cache = M.init_cache(mcfg, len(tokens), 8, device=dev)
    tok = torch.as_tensor(tokens).to(dev)
    V = mcfg.padded_vocab

    def decode_knn():
        logits, _ = M.decode_step(params, mcfg, tok, cache, 0)
        h = params.embed[tok.long()].float()
        return mix_logits(logits, store.knn_logits(h, V), lam).argmax(-1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_knn()
    torch.cuda.synchronize()
    return profile_device(decode_knn, (time.perf_counter() - t0) * 1e3)


def recorder(calls: list, pages: dict):
    """A scorer that records each call the descent makes (fids, queries,
    metric and the filter inputs) into ``calls`` and the tree arrays into
    ``pages`` (once), then scores through the plain version: no launch."""
    from repro_torch.kernels.frontier import frontier_scores_torch

    def scorer(fids, queries, vecs, radius, iv, lv, *, metric, pdist=None, qpd=None,
               rq=None):
        if "vecs" not in pages:
            pages.update(vecs=vecs.clone(), radius=radius.clone(), iv=iv.clone(),
                         lv=lv.clone())
        if pdist is not None and "pdist" not in pages:
            pages["pdist"] = pdist.clone()
        clone = lambda t: None if t is None else t.clone()
        calls.append(dict(fids=fids.clone(), queries=queries.clone(), metric=metric,
                          pdist=None if pdist is None else pages["pdist"],
                          qpd=clone(qpd), rq=clone(rq)))
        return frontier_scores_torch(fids, queries, vecs, radius, iv, lv, metric=metric,
                                     pdist=pdist, qpd=qpd, rq=rq)
    return scorer


def frontier_replay(captured: dict, pages: dict, on_card: bool):
    """Each captured level through the kernel, bitwise against the plain
    version, timed and bounded (phases 5b and 12, module docstring).
    ``captured`` maps a label to one descent's scorer calls (``recorder``),
    ``pages`` holds the tree arrays they were scored against."""
    import torch

    from repro_torch.kernels.frontier import frontier_scores, frontier_scores_torch
    sync, time_ms, _ = timers(on_card)
    cap = pages["vecs"].shape[1]
    out = {}
    for label, calls in captured.items():
        levels = []
        for c in calls:
            fids = c["fids"]
            filt = {k: c[k] for k in ("pdist", "qpd", "rq") if c[k] is not None}
            args = (fids, c["queries"], pages["vecs"], pages["radius"], pages["iv"],
                    pages["lv"])
            kw = dict(metric=c["metric"], **filt)
            got = frontier_scores(*args, **kw)
            want = frontier_scores_torch(*args, **kw)
            sync()
            for name, g, w in zip(("dmax", "score", "leaf_d", "dq"), got, want):
                check(torch.equal(g, w), f"replayed frontier {label} w={fids.shape[1]} "
                                         f"{name} not bitwise")
            nbytes, nops, n_live = frontier_traffic(fids, c["queries"], want, cap, bool(filt))
            bms, by = bound(nbytes, nops)
            kernel = lambda: frontier_scores(*args, **kw)
            row = dict(w=fids.shape[1], pairs=fids.numel(), prune=bool(filt),
                       distinct_nodes=int(torch.unique(fids[fids >= 0]).numel()),
                       live_evals=n_live, bound_ms=bms, bound_by=by, ms=time_ms(kernel))
            if on_card:
                row.update(device_ms=device_ms(kernel))
            levels.append(row)
            del got, want
        total = {k: sum(r[k] for r in levels) for k in levels[0]
                 if k in ("ms", "device_ms", "bound_ms", "live_evals", "pairs")}
        out[label] = dict(levels=levels, per_descent=total)
    return out


def narrow_frontier_inputs(rng, cfg: dict, dev):
    """The narrow scorer's synthetic geometry (phase 3): b x F slots on
    ``kernel_N`` random pages of ``capacity`` x ``dims`` uniform rows, 10%
    empty slots, 80% valid entries, half the pages leaves.  Returns the
    positional arguments of ``frontier_scores`` and the filter inputs."""
    import numpy as np
    import torch
    N, cap, dim = cfg["kernel_N"], cfg["capacity"], cfg["dims"]
    b, F = cfg["kernel_b"], cfg["kernel_F"]
    t = lambda a: torch.from_numpy(a).to(dev)
    vecs = t(rng.random((N, cap, dim), np.float32))
    radius = t(np.abs(rng.normal(0, 0.1, (N, cap))).astype(np.float32))
    valid = rng.random((N, cap)) < 0.8
    is_leaf = rng.random(N) < 0.5
    iv, lv = t(valid & ~is_leaf[:, None]), t(valid & is_leaf[:, None])
    fids_np = rng.integers(0, N, (b, F)).astype(np.int32)
    fids_np[rng.random((b, F)) < 0.1] = -1                  # empty slots
    queries = t(rng.random((b, dim), np.float32))
    qpd_np = np.abs(rng.normal(0.5, 0.3, (b, F))).astype(np.float32)
    qpd_np[fids_np < 0] = np.inf
    filt = dict(pdist=t(np.abs(rng.normal(0.5, 0.3, (N, cap))).astype(np.float32)),
                qpd=t(qpd_np), rq=t(np.abs(rng.normal(0.2, 0.1, b)).astype(np.float32)))
    return (t(fids_np), queries, vecs, radius, iv, lv), filt


@contextlib.contextmanager
def split_merge_probe(sync):
    """For the calls of ``apply_mutations`` inside the block: the seconds
    of the split and the merge pass (``resolve_overflows`` and
    ``resolve_underflows``, the device synchronised around each), the rows
    each pass was given, the internal nodes the split pass added (a split
    that climbed above the leaves), the nodes the merge pass freed and the
    levels it collapsed, and its re-splits (every ``_promote_and_partition``
    of a two-node union is a redistribution)."""
    import numpy as np
    import torch

    from repro_torch.core import smtree

    rec = dict(split_seconds=0.0, merge_seconds=0.0, split_rows=0, merge_rows=0,
               internal_nodes_added=0, nodes_freed=0, levels_collapsed=0,
               redistributions=0)
    names = ("resolve_overflows", "resolve_underflows", "_promote_and_partition")
    orig = {name: getattr(smtree, name) for name in names}

    def shape(t):
        return (int((t.alive & ~t.is_leaf).sum()), int(t.alive.sum()), int(t.height))

    def rows(statuses, ops, status, op):
        ops = np.asarray(torch.as_tensor(ops).cpu()).reshape(-1)
        return int(((np.asarray(statuses) == status) & (ops == op)).sum())

    def overflows(tree, ops, xs, oids, statuses):
        rec["split_rows"] += rows(statuses, ops, smtree.ST_OVERFLOW, smtree.OP_INSERT)
        i0, _, _ = shape(tree)
        sync()
        t0 = time.perf_counter()
        out = orig["resolve_overflows"](tree, ops, xs, oids, statuses)
        sync()
        rec["split_seconds"] += time.perf_counter() - t0
        rec["internal_nodes_added"] += shape(tree)[0] - i0
        return out

    def underflows(tree, ops, oids, statuses):
        rec["merge_rows"] += rows(statuses, ops, smtree.ST_UNDERFLOW, smtree.OP_DELETE)
        _, a0, h0 = shape(tree)
        sync()
        t0 = time.perf_counter()
        out = orig["resolve_underflows"](tree, ops, oids, statuses)
        sync()
        rec["merge_seconds"] += time.perf_counter() - t0
        _, a1, h1 = shape(tree)
        rec["nodes_freed"] += a0 - a1
        rec["levels_collapsed"] += h0 - h1
        return out

    def partition(t, D, *a, **kw):
        rec["redistributions"] += D.shape[0] == 2 * t.capacity
        return orig["_promote_and_partition"](t, D, *a, **kw)

    for name, fn in zip(names, (overflows, underflows, partition)):
        setattr(smtree, name, fn)
    try:
        yield rec
    finally:
        for name, fn in orig.items():
            setattr(smtree, name, fn)
    # a merge frees one node, a root collapse one more and a level
    rec["merges"] = rec["nodes_freed"] - rec["levels_collapsed"]
    for kind in ("split", "merge"):
        n = rec[kind + "_rows"]
        rec[f"ms_per_{kind}_row"] = rec[kind + "_seconds"] * 1e3 / n if n else None


def split_merge_cohort(tree, Xall, n_rows: int, first_id: int, rng):
    """A conflict-free cohort of about ``n_rows`` rows on the leaves' own
    structure (read from the tree once, on the host): half inserts of new
    ids, piled ``cap - count + cap // 4`` deep on every leaf under
    consecutive level-1 nodes (each leaf overflows, and so do their
    parents); half deletes, that thin every leaf under the next level-1
    nodes to ``min_fill - 1`` (the thinned siblings merge, and the
    parents underflow in turn) and then one leaf under each of the
    following ones (beside untouched siblings, which redistribute).
    Returns (ops, xs, oids) in a shuffled log order."""
    import numpy as np

    from repro_torch.core import smtree

    cap, mf = tree.capacity, tree.min_fill
    a = {f: getattr(tree, f).cpu().numpy() for f in ("count", "parent", "alive",
                                                      "is_leaf", "oid")}
    kids = {}
    for leaf in np.nonzero(a["alive"] & a["is_leaf"])[0]:
        kids.setdefault(int(a["parent"][leaf]), []).append(int(leaf))
    parents = iter(sorted(kids))
    half = n_rows // 2
    ins_x = []
    while len(ins_x) < half:
        for leaf in kids[next(parents)]:
            x = Xall[a["oid"][leaf, 0]]
            k = cap - int(a["count"][leaf]) + cap // 4
            ins_x += list(np.clip(x + rng.normal(0, 1e-4, (k, x.shape[0])), 0, 1))
    victims = []
    while len(victims) < half // 2:                  # thinned parents: merges
        for leaf in kids[next(parents)]:
            victims += a["oid"][leaf, :a["count"][leaf] - mf + 1].tolist()
    while len(victims) < half:                       # one leaf each: re-splits
        leaf = kids[next(parents)][0]
        victims += a["oid"][leaf, :a["count"][leaf] - mf + 1].tolist()
    ins_x = np.asarray(ins_x, np.float32)
    ops = np.concatenate([np.full(len(ins_x), smtree.OP_INSERT),
                          np.full(len(victims), smtree.OP_DELETE)]).astype(np.int32)
    oids = np.concatenate([first_id + np.arange(len(ins_x)), victims]).astype(np.int32)
    xs = np.vstack([ins_x, Xall[victims]]).astype(np.float32)
    order = rng.permutation(len(ops))
    return ops[order], xs[order], oids[order]


def split_merge_phase(cfg: dict, eng, Xall, keep, Qb, F_exact: int, check_exact,
                      device: str):
    """Phase 5c (module docstring): a cohort through the device split and
    merge passes on one clone of the index and through the host plane on
    another, held bitwise, then validated and re-checked exactly."""
    import numpy as np
    import torch

    from repro_torch.core import smtree
    from repro_torch.core.distributed import brute_force_knn
    from repro_torch.core.engine import SMTreeEngine
    from repro_torch.stream.batcher import escalate_rows

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, _, wall = timers(on_card)
    grown = smtree.needs_headroom(eng.tree)
    if grown:
        eng.tree = smtree.grow_tree(eng.tree)
    rng = np.random.default_rng(21)
    ops, xs, oids = split_merge_cohort(eng.tree, Xall, cfg["sm_rows"], len(Xall), rng)
    inserted = oids[ops == smtree.OP_INSERT]
    tree_a, tree_b = smtree.clone_tree(eng.tree), smtree.clone_tree(eng.tree)

    # clone A: the fast scan, then the device split and merge passes
    with split_merge_probe(sync) as probe:
        (_, st_a), a_s = wall(lambda: smtree.apply_mutations(tree_a, ops, xs, oids))
    st_a = st_a.cpu().numpy()
    # clone B: the fast scan alone, then the host plane
    (_, st_b), b_scan_s = wall(lambda: smtree.apply_mutations(
        tree_b, ops, xs, oids, splits=False, merges=False))
    st_b = st_b.cpu().numpy().copy()
    scan_counts = {name: int((st_b == code).sum()) for name, code in (
        ("applied", smtree.ST_APPLIED), ("overflow", smtree.ST_OVERFLOW),
        ("underflow", smtree.ST_UNDERFLOW), ("notfound", smtree.ST_NOTFOUND))}
    tree_b, host_s = wall(lambda: escalate_rows(tree_b, st_b, ops, xs, oids))
    normal = np.where(np.isin(st_a, (smtree.ST_SPLIT, smtree.ST_MERGE)),
                      smtree.ST_APPLIED, st_a)
    check(np.array_equal(normal, st_b), "device passes: statuses differ from the host plane")
    check(bool((st_b == smtree.ST_APPLIED).all()), "a row of the cohort did not apply")
    for f in smtree.ARRAY_FIELDS:
        check(torch.equal(getattr(tree_a, f), getattr(tree_b, f)),
              f"device passes: field {f} differs from the host plane")
    del tree_b
    n_split = int((st_a == smtree.ST_SPLIT).sum())
    n_merge = int((st_a == smtree.ST_MERGE).sum())
    check(n_split >= cfg["sm_min_rows"] and n_merge >= cfg["sm_min_rows"],
          f"{n_split} rows resolved by splits, {n_merge} by merges")
    check(probe["internal_nodes_added"] > 0, "no split climbed above the leaves")
    check(probe["merges"] > 0, "the merge branch was never taken")
    check(probe["redistributions"] > 0, "the redistribute branch was never taken")
    eng_a = SMTreeEngine(tree_a)
    _, val_s = wall(eng_a.validate)

    # the exact kNN check against a scan of the live set
    new_x = xs[ops == smtree.OP_INSERT][np.argsort(inserted)]
    Xall2 = np.vstack([Xall, new_x])
    keep2 = np.concatenate([keep, np.ones(len(new_x), bool)])
    keep2[oids[ops == smtree.OP_DELETE]] = False
    check(eng_a.n_objects == int(keep2.sum()), "object count after the cohort")
    live_ids = torch.from_numpy(np.nonzero(keep2)[0]).to(dev)
    Xlive = torch.from_numpy(Xall2[keep2]).to(dev)
    half = cfg["b_recheck"] // 2
    Qr = torch.cat([Qb[:half], torch.from_numpy(new_x[:half]).to(dev)])
    res = eng_a.knn(Qr, k=K, max_frontier=F_exact)
    sd, si = brute_force_knn(Xlive, Qr, k=K + 1, metric="d_inf", device=device)
    n_ok, n_ids = check_exact(res, sd, si, lambda i: live_ids[i],
                              "knn after the split and merge passes")
    emit("device_split_merge", rows=len(ops), inserts=int(len(inserted)),
         deletes=int(len(ops) - len(inserted)), needs_headroom=grown,
         max_nodes=tree_a.max_nodes, scan_statuses=scan_counts,
         resolved_by_split=n_split, resolved_by_merge=n_merge,
         seconds_total=a_s,
         fast_scan_seconds=a_s - probe["split_seconds"] - probe["merge_seconds"],
         split_pass=dict(seconds=probe["split_seconds"], rows=probe["split_rows"],
                         ms_per_row=probe["ms_per_split_row"],
                         internal_nodes_added=probe["internal_nodes_added"]),
         merge_pass=dict(seconds=probe["merge_seconds"], rows=probe["merge_rows"],
                         ms_per_row=probe["ms_per_merge_row"], merges=probe["merges"],
                         redistributions=probe["redistributions"],
                         levels_collapsed=probe["levels_collapsed"]),
         host_plane=dict(fast_scan_seconds=b_scan_s, escalate_rows_seconds=host_s,
                         rows=scan_counts["overflow"] + scan_counts["underflow"]),
         bitwise_vs_host_plane=True, validate=True, validate_seconds=val_s,
         height=int(tree_a.height), recheck_rows_bitwise=n_ok, recheck_rows_ids=n_ids)
    del tree_a, eng_a, Xlive


def run(cfg: dict, device: str):
    import numpy as np
    import torch

    from repro_torch.core import smtree
    from repro_torch.core.distributed import brute_force_knn
    from repro_torch.core.engine import SMTreeEngine
    from repro_torch.data.datagen import clustered
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance import (pairwise_distance,
                                              pairwise_distance_torch)
    from repro_torch.kernels.frontier import (frontier_scores,
                                              frontier_scores_torch)
    from repro_torch.roofline.counts import distance_work

    on_card = device == "cuda"
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync, time_ms, wall = timers(on_card)

    # ---------------------------------------------------------------- 1
    if on_card:
        emit("device", kind=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
             torch=torch.__version__, cuda=torch.version.cuda)

    # ---------------------------------------------------------------- 2
    if on_card:
        t0 = time.perf_counter()
        secs = _build.build_all()
        total = time.perf_counter() - t0
        ptxas = {name: ptxas_summary(_build.build_log(name)) for name in secs}
        emit("build", seconds_total=total, seconds=secs, ptxas=ptxas)

    # ---------------------------------------------------------------- 3
    rng = np.random.default_rng(0)
    dim, cap = cfg["dims"], cfg["capacity"]
    b, F = cfg["kernel_b"], cfg["kernel_F"]
    args, filt = narrow_frontier_inputs(rng, cfg, dev)
    fids, queries = args[:2]
    frontier_rows = {}
    for metric in ("d_inf", "l2", "l1"):
        for prune in (False, True):
            kw = dict(metric=metric, **(filt if prune else {}))
            got = frontier_scores(*args, **kw)
            want = frontier_scores_torch(*args, **kw)
            sync()
            for name, g, w in zip(("dmax", "score", "leaf_d", "dq"), got, want):
                check(torch.equal(g, w),
                      f"frontier {metric} prune={prune} {name} not bitwise")
            kernel = lambda: frontier_scores(*args, **kw)
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: frontier_scores_torch(*args, **kw), iters=5)
            nbytes, nops, n_live = frontier_traffic(fids, queries, want, cap, prune)
            bms, by = bound(nbytes, nops)
            frontier_rows[(metric, prune)] = dict(
                ms=ms, device_ms=device_ms(kernel) if on_card else None,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=nops, live_evals=n_live, max_abs_err=0.0)
    emit("kernel_frontier", shapes=dict(b=b, F=F, cap=cap, dim=dim, N=cfg["kernel_N"]),
         bitwise=True, results={f"{m}/{'prune' if p else 'plain'}": r
                                for (m, p), r in frontier_rows.items()})

    dist_rows = {}
    for shape, (nq, ne) in (("path", (cfg["dist_path_nq"], cfg["dist_path_ne"])),
                            ("synthetic", (cfg["dist_nq"], cfg["dist_ne"]))):
        q = torch.from_numpy(rng.random((nq, dim), np.float32)).to(dev)
        e = torch.from_numpy(rng.random((ne, dim), np.float32)).to(dev)
        libcalls = {
            "d_inf": lambda: torch.cdist(q, e, p=float("inf")),
            "sqeuclidean": lambda: torch.cdist(q, e, p=2.0) ** 2,
            "ip": lambda: -(q @ e.T),
        }
        for metric in ("d_inf", "sqeuclidean", "ip"):
            got = pairwise_distance(q, e, metric)
            want = pairwise_distance_torch(q, e, metric)
            sync()
            err = float((got - want).abs().max())
            if metric == "d_inf":
                check(torch.equal(got, want), f"distance {shape} d_inf not bitwise")
            else:
                tol_ok = bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
                check(tol_ok, f"distance {shape} {metric} beyond 1e-5 (max abs err {err})")
            del got, want
            kernel = lambda: pairwise_distance(q, e, metric)
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: pairwise_distance_torch(q, e, metric), iters=3,
                               warmup=1)
            lib_ms = time_ms(libcalls[metric], iters=5, warmup=1) if on_card else None
            nops, nbytes = distance_work(nq, ne, dim, prune=False)
            bms, by = bound(nbytes, nops)
            dist_rows[(shape, metric)] = dict(
                ms=ms, device_ms=device_ms(kernel) if on_card else None,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err)
        del q, e, libcalls
    emit("kernel_distance",
         shapes=dict(path=dict(nq=cfg["dist_path_nq"], ne=cfg["dist_path_ne"], d=dim),
                     synthetic=dict(nq=cfg["dist_nq"], ne=cfg["dist_ne"], d=dim)),
         results={f"{s}/{m}": r for (s, m), r in dist_rows.items()})
    del filt, args, fids, queries

    # ---------------------------------------------------------------- 4-5
    # the main path: launch counts are zeroed here and read after phase 5
    frontier_scores.launches = 0
    frontier_scores.pruned_launches = 0
    pairwise_distance.launches = 0

    n = cfg["n"]
    X = clustered(n, dims=dim, seed=0)
    eng, build_s = wall(lambda: SMTreeEngine.build(
        X, capacity=cap, metric="d_inf", device=device))
    t = eng.tree
    emit("build_tree", n=n, dims=dim, capacity=cap, seconds=build_s,
         n_nodes=int(t.n_nodes), max_nodes=t.max_nodes, height=int(t.height))
    Xd = torch.from_numpy(X).to(dev)
    qrng = np.random.default_rng(1)

    def noisy_queries(m):
        rows = qrng.integers(0, n, m)
        return (X[rows] + qrng.normal(0, 0.01, (m, dim))).astype(np.float32)

    # (a) bench geometry
    def launch_counts():
        return dict(frontier=frontier_scores.launches - frontier_scores.pruned_launches,
                    frontier_pruned=frontier_scores.pruned_launches,
                    distance=pairwise_distance.launches)

    def per_call(fn):
        c0 = launch_counts()
        out = fn()
        return out, {k: v - c0[k] for k, v in launch_counts().items()}

    Qa = torch.from_numpy(noisy_queries(cfg["b_bench"])).to(dev)
    _, knn_launches = per_call(lambda: eng.knn(Qa, k=K, max_frontier=BENCH_F))
    times = []
    for _ in range(cfg["timing_reps"]):
        res, s = wall(lambda: eng.knn(Qa, k=K, max_frontier=BENCH_F))
        times.append(s * 1e3)
    bench_times = times
    # the cohort's frontiers as the descent passes them to the scorer,
    # recorded through the plain scorer (no launch) for phase 5b
    index_calls, index_pages = {}, {}
    eng.knn(Qa, k=K, max_frontier=BENCH_F,
            _scorer=recorder(index_calls.setdefault("bench", []), index_pages))
    emit("knn_bench_geometry", b=cfg["b_bench"], k=K, max_frontier=BENCH_F,
         parent_prune=True, ms_per_cohort=times, launches_per_call=knn_launches,
         dist_evals_per_query=float(res.dist_evals.float().mean()),
         page_hits_per_query=float(res.page_hits.float().mean()),
         overflow_share=float(res.overflow.float().mean()))

    # (b) exact geometry, held bitwise against the scan
    Qb = torch.from_numpy(noisy_queries(cfg["b_exact"])).to(dev)
    tried = {}
    for Fx in EXACT_FS:
        res = eng.knn(Qb, k=K, max_frontier=Fx)
        tried[Fx] = float(res.overflow.float().mean())
        if tried[Fx] == 0.0:
            break
    F_exact = Fx
    times = [wall(lambda: eng.knn(Qb, k=K, max_frontier=F_exact))[1] * 1e3
             for _ in range(cfg["timing_reps"])]
    eng.knn(Qb, k=K, max_frontier=F_exact,
            _scorer=recorder(index_calls.setdefault("exact", []), index_pages))
    (scan_d, scan_i), scan_launches = per_call(
        lambda: brute_force_knn(Xd, Qb, k=K + 1, metric="d_inf",
                                device=device))

    def check_exact(res, sd, si, ids_of, what):
        ok = ~res.overflow
        check(bool(ok.any()), f"{what}: every row overflowed")
        check(torch.equal(res.dists[ok], sd[ok, :K]),
              f"{what}: dists differ from the scan on non-overflow rows")
        distinct = ok & (sd[:, K - 1] != sd[:, K])
        tree_ids = torch.sort(res.ids[distinct].long(), 1).values
        want_ids = torch.sort(ids_of(si[distinct, :K]), 1).values
        check(torch.equal(tree_ids, want_ids),
              f"{what}: ids differ from the scan where the k-th distance is unique")
        return int(ok.sum()), int(distinct.sum())

    n_ok, n_ids = check_exact(res, scan_d, scan_i, lambda i: i, "exact knn")
    emit("knn_exact_geometry", b=cfg["b_exact"], k=K, overflow_share_by_F=tried,
         max_frontier=F_exact, no_overflow=tried[F_exact] == 0.0,
         ms_per_cohort=times, rows_checked_bitwise=n_ok, rows_ids_checked=n_ids,
         scan_launches_per_call=scan_launches,
         dist_evals_per_query=float(res.dist_evals.float().mean()),
         page_hits_per_query=float(res.page_hits.float().mean()))

    # where a cohort's time goes: device time by kernel under torch.profiler,
    # against the cohort's unprofiled wall time (median of the runs above)
    if on_card:
        from torch.autograd import DeviceType
        prof_rows = {}
        for label, Q, Fx, wall_ms in (("bench", Qa, BENCH_F, bench_times),
                                      ("exact", Qb, F_exact, times)):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                eng.knn(Q, k=K, max_frontier=Fx)
                torch.cuda.synchronize()
            kern = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA]
            kern.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
            busy = sum(ev.self_device_time_total for ev in kern) / 1e3
            med = float(np.median(wall_ms))
            prof_rows[label] = dict(
                wall_ms_median=med, device_busy_ms=busy,
                device_idle_share=max(0.0, 1.0 - busy / med),
                kernels=[dict(name=ev.key[:72], ms=ev.self_device_time_total / 1e3,
                              calls=ev.count) for ev in kern[:10]])
        emit("profile_knn", max_frontier={"bench": BENCH_F, "exact": F_exact},
             results=prof_rows)

    # (d) range search against the scan
    radius = 0.02
    rres = eng.range_search(Qb, radius, max_results=128, max_frontier=F_exact)
    D = pairwise_distance(Qb, Xd, "d_inf")
    n_rows = 0
    for r in range(Qb.shape[0]):
        if bool(rres.overflow[r]):
            continue
        got = set(rres.ids[r][rres.ids[r] >= 0].tolist())
        want = set(torch.nonzero(D[r] <= radius).flatten().tolist())
        check(got == want, f"range_search row {r}: {len(got)} ids vs scan {len(want)}")
        n_rows += 1
    emit("range_search", radius=radius, max_results=128, max_frontier=F_exact,
         rows_checked=n_rows,
         mean_hits=float((rres.ids >= 0).float().sum(1).mean()),
         overflow_share=float(rres.overflow.float().mean()))
    del D

    # 5. Insert/Delete: splits from a pile of inserts on one point
    irng = np.random.default_rng(2)
    alive0 = int(t.alive.sum())
    splits = merges = 0
    extra = []
    centre = X[int(irng.integers(n))]

    def track(before):
        nonlocal splits, merges
        after = int(eng.tree.alive.sum())
        splits += max(0, after - before)
        merges += max(0, before - after)
        return after

    alive_now = alive0
    t0 = time.perf_counter()
    for j in range(cfg["n_insert"]):
        if j % 2 == 0:
            x = centre + irng.normal(0, 1e-4, dim)
        else:
            x = X[int(irng.integers(n))] + irng.normal(0, 0.01, dim)
        x = np.clip(x, 0, 1).astype(np.float32)
        eng.insert(x, n + j)
        extra.append(x)
        alive_now = track(alive_now)
    # deletes: thin every leaf child of one parent to min_fill + 1 entries
    # (no underflow), then take two more from one of them — it underflows
    # and its nearest sibling has room, so the two merge; drain three other
    # leaves below min_fill next to full siblings (the union re-splits)
    tr = eng.tree
    counts, oids = tr.count.cpu().numpy(), tr.oid.cpu().numpy()
    childs = tr.child.cpu().numpy()
    leaves = np.nonzero(tr.is_leaf.cpu().numpy() & tr.alive.cpu().numpy())[0]
    mf = tr.min_fill
    p = int(tr.parent[int(leaves[0])])
    check(p >= 0, "the first leaf has no parent")
    kids = childs[p, :counts[p]]
    victims = [o for c in kids for o in oids[c, mf + 1:counts[c]]]
    victims += list(oids[kids[0], :2])
    for nd in leaves[-3:]:
        victims += list(oids[nd, :counts[nd] - mf + 2])
    deleted = set()
    for oid in map(int, victims):
        vec = X[oid] if oid < n else extra[oid - n]
        check(eng.delete(vec, oid), f"delete of {oid} not found")
        deleted.add(oid)
        alive_now = track(alive_now)
    for oid in irng.choice(n, 200, replace=False):
        oid = int(oid)
        if oid in deleted:
            continue
        check(eng.delete(X[oid], oid), f"delete of {oid} not found")
        deleted.add(oid)
        alive_now = track(alive_now)
    check(not eng.delete(X[0] + 5.0, n + cfg["n_insert"] + 7),
          "delete of an absent id reported found")
    mut_s = time.perf_counter() - t0
    check(splits > 0 and merges > 0, f"{splits} node splits, {merges} merges")
    _, val_s = wall(eng.validate)
    n_live = n + cfg["n_insert"] - len(deleted)
    check(eng.n_objects == n_live, f"n_objects {eng.n_objects} != {n_live}")
    Xall = np.vstack([X, np.asarray(extra)])
    keep = np.ones(len(Xall), bool)
    keep[sorted(deleted)] = False
    live_ids = torch.from_numpy(np.nonzero(keep)[0]).to(dev)
    Xlive = torch.from_numpy(Xall[keep]).to(dev)
    Qr = torch.cat([Qb[:cfg["b_recheck"] // 2],
                    torch.from_numpy(np.asarray(extra[:cfg["b_recheck"] // 2])).to(dev)])
    res = eng.knn(Qr, k=K, max_frontier=F_exact)
    sd, si = brute_force_knn(Xlive, Qr, k=K + 1, metric="d_inf", device=device)
    n_ok, n_ids = check_exact(res, sd, si, lambda i: live_ids[i], "knn after mutations")
    emit("insert_delete", inserts=cfg["n_insert"], deletes=len(deleted),
         node_splits=splits, node_merges=merges, seconds=mut_s,
         validate_seconds=val_s, validate=True, n_objects=eng.n_objects,
         height=int(eng.tree.height), recheck_rows_bitwise=n_ok,
         recheck_overflow_share=float(res.overflow.float().mean()))

    launches = launch_counts()
    if on_card:
        for name, c in launches.items():
            check(c > 0, f"kernel {name} never launched on the main path")

    # ---------------------------------------------------------------- 5b
    replay = frontier_replay(index_calls, index_pages, on_card)
    emit("frontier_replay_index", n=n, dim=dim, metric="d_inf", k=K,
         geometries={"bench": dict(b=cfg["b_bench"], max_frontier=BENCH_F),
                     "exact": dict(b=cfg["b_exact"], max_frontier=F_exact)},
         results=replay)
    del index_calls, index_pages, replay

    # ---------------------------------------------------------------- 5c
    split_merge_phase(cfg, eng, Xall, keep, Qb, F_exact, check_exact, device)

    # ---------------------------------------------------------------- 6
    def parity(tree, Q, Fx, what):
        h = int(tree.height)
        kw = dict(k=K, F=Fx, height=h, level_stats=True, prune=True)
        a, (bb_a, bp_a) = smtree._knn_cohort(tree, Q, float("inf"), **kw)
        p, (bb_p, bp_p) = smtree._knn_cohort(tree, Q, float("inf"),
                                             scorer=frontier_scores_torch, **kw)
        for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
            check(torch.equal(getattr(a, f), getattr(p, f)),
                  f"{what}: kernel and plain paths differ in {f}")
        check(torch.equal(bb_a, bb_p) and torch.equal(bp_a, bp_p),
              f"{what}: level stats differ")
        return dict(b=Q.shape[0], max_frontier=Fx, bitwise=True,
                    overflow_share=float(a.overflow.float().mean()))

    par = {f"d_inf_{n}": parity(eng.tree, Qb[:cfg["b_parity"]], F_exact, "d_inf")}
    del eng, Xd, Xlive
    for metric, seed in (("l2", 2), ("l1", 3)):
        Xs = clustered(cfg["n_small"], dims=dim, seed=seed)
        es = SMTreeEngine.build(Xs, capacity=cap, metric=metric, device=device)
        rows = np.random.default_rng(seed).integers(0, len(Xs), cfg["b_parity"])
        Qs = torch.from_numpy((Xs[rows] + 0.01).astype(np.float32)).to(dev)
        par[f"{metric}_{cfg['n_small']}"] = parity(es.tree, Qs, EXACT_FS[0], metric)
    emit("descent_kernel_vs_plain", results=par)

    d_inf_p = frontier_rows[("d_inf", True)]
    d_inf_u = frontier_rows[("d_inf", False)]
    dd = dist_rows[("path", "d_inf")]
    ds = dist_rows[("synthetic", "d_inf")]
    kernels = [
        dict(name="frontier_scores", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:109",
             launches=launches["frontier"],
             launches_per_pass={"knn_bench": knn_launches["frontier"]},
             max_abs_err=0.0, ms=d_inf_u["ms"],
             plain_ms=d_inf_u["plain_ms"], bound_ms=d_inf_u["bound_ms"],
             bound_by=d_inf_u["bound_by"], library_ms=None),
        dict(name="frontier_scores[parent_prune]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:121",
             launches=launches["frontier_pruned"],
             launches_per_pass={"knn_bench": knn_launches["frontier_pruned"]},
             max_abs_err=0.0,
             ms=d_inf_p["ms"], plain_ms=d_inf_p["plain_ms"],
             bound_ms=d_inf_p["bound_ms"], bound_by=d_inf_p["bound_by"],
             library_ms=None),
        dict(name="pairwise_distance", route="cuda",
             source="src/repro_torch/kernels/csrc/distance.cu",
             replaces="src/repro/kernels/distance.py:33",
             launches=launches["distance"],
             launches_per_pass={"brute_force_knn": scan_launches["distance"]},
             max_abs_err=dd["max_abs_err"], ms=dd["ms"], device_ms=dd["device_ms"],
             plain_ms=dd["plain_ms"], bound_ms=dd["bound_ms"],
             bound_by=dd["bound_by"], library_ms=dd["library_ms"],
             shape=dict(nq=cfg["dist_path_nq"], ne=cfg["dist_path_ne"], d=dim),
             synthetic=dict(nq=cfg["dist_nq"], ne=cfg["dist_ne"], d=dim,
                            **{k: ds[k] for k in ("ms", "device_ms", "plain_ms",
                                                  "bound_ms", "library_ms")})),
    ]
    return kernels


def run_forest(cfg: dict, device: str):
    """The SM-forest (the main path's third step): the 1M-object set round
    robin over ``n_shards`` shards, its kNN through the kernels held against
    the plain scorer and the sharded scan, the per-query engine against the
    cohort engine on one shard, and an owner-routed mutation cohort held
    against the same log applied one row at a time.  Its launch counts are
    zeroed just before and read just after (a pass of its own, so the index
    slice's counts stay comparable).  Returns the pass's launch counts and
    the per-call counts of ``forest_knn`` and of the sharded scan."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as fd
    from repro_torch.core import smtree
    from repro_torch.data.datagen import clustered
    from repro_torch.kernels.distance import pairwise_distance
    from repro_torch.kernels.frontier import frontier_scores, frontier_scores_torch

    on_card = device == "cuda"
    dev = torch.device(device)
    _, _, wall = timers(on_card)
    S, dim, cap, n = cfg["n_shards"], cfg["dims"], cfg["capacity"], cfg["n"]

    def launch_counts():
        return dict(frontier=frontier_scores.launches - frontier_scores.pruned_launches,
                    frontier_pruned=frontier_scores.pruned_launches,
                    distance=pairwise_distance.launches)

    def per_call(fn):
        c0 = launch_counts()
        out = fn()
        return out, {k: v - c0[k] for k, v in launch_counts().items()}

    def sliced_scan(Xd, Q, k):
        """The group form of ``brute_force_knn`` with its S ranks run one
        after another on this card: each rank's contiguous slice scanned
        and cut to its k best, then the k-way merge of the candidates."""
        size = Xd.shape[0] // S
        parts = [fd._scan_topk(Xd[r * size:(r + 1) * size], Q, k, "d_inf")
                 for r in range(S)]
        return fd._merge_topk(
            torch.stack([d for d, _ in parts]),
            torch.stack([i + r * size for r, (_, i) in enumerate(parts)]), k)

    def any_overflow(forest, Q, Fx):
        """Per query: did any shard's descent truncate its frontier (the
        forest's result is exact where none did)."""
        return torch.stack([smtree.knn(t, Q, k=K, max_frontier=Fx).overflow
                            for t in fd.unstack_forest(forest)]).any(0)

    def check_exact(d, i, ovf, sd, si, ids_of, what):
        ok = ~ovf
        check(bool(ok.any()), f"{what}: every row overflowed")
        check(torch.equal(d[ok], sd[ok, :K]), f"{what}: dists differ from the scan")
        distinct = ok & (sd[:, K - 1] != sd[:, K])
        got = torch.sort(i[distinct].long(), 1).values
        want = torch.sort(ids_of(si[distinct, :K]), 1).values
        check(torch.equal(got, want),
              f"{what}: ids differ from the scan where the k-th distance is unique")
        return int(ok.sum()), int(distinct.sum())

    # the forest pass: launch counts zeroed here and read at its end
    frontier_scores.launches = 0
    frontier_scores.pruned_launches = 0
    pairwise_distance.launches = 0

    # ---------------------------------------------------------------- build
    X = clustered(n, dims=dim, seed=0)
    forest, build_s = wall(lambda: fd.build_forest(X, S, capacity=cap, metric="d_inf",
                                                   device=device))
    height = fd.common_static_height(forest)
    nbytes = sum(getattr(forest, f).numel() * getattr(forest, f).element_size()
                 for f in smtree.ARRAY_FIELDS)
    emit("forest_build", n=n, dims=dim, capacity=cap, n_shards=S, seconds=build_s,
         heights=forest.height.tolist(), common_height=height,
         n_nodes=forest.n_nodes.tolist(), max_nodes=forest.max_nodes,
         device_bytes=nbytes)
    check(height is not None, "round-robin shards of one size differ in height")
    Xd = torch.from_numpy(X).to(dev)
    qrng = np.random.default_rng(11)

    def noisy_queries(m):
        rows = qrng.integers(0, n, m)
        return torch.from_numpy((X[rows] + qrng.normal(0, 0.01, (m, dim)))
                                .astype(np.float32)).to(dev)

    # ---------------------------------------------------------------- knn
    Qa = noisy_queries(cfg["b_bench"])
    (da, ia), knn_launches = per_call(
        lambda: fd.forest_knn(forest, Qa, k=K, max_frontier=BENCH_F))
    bench_times = [wall(lambda: fd.forest_knn(forest, Qa, k=K, max_frontier=BENCH_F))[1]
                   * 1e3 for _ in range(cfg["timing_reps"])]
    # the same forest through the plain scorer: the forest's outputs and
    # every shard's five result fields bitwise
    dp, ip = fd.forest_knn(forest, Qa, k=K, max_frontier=BENCH_F,
                           _scorer=frontier_scores_torch)
    check(torch.equal(da, dp) and torch.equal(ia, ip),
          "forest_knn: kernel and plain paths differ")
    for s, t in enumerate(fd.unstack_forest(forest)):
        kw = dict(k=K, F=BENCH_F, height=height)
        a = smtree._knn_cohort(t, Qa, float("inf"), **kw)
        p = smtree._knn_cohort(t, Qa, float("inf"), scorer=frontier_scores_torch, **kw)
        for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
            check(torch.equal(getattr(a, f), getattr(p, f)),
                  f"shard {s}: kernel and plain descents differ in {f}")
    ovf_a = any_overflow(forest, Qa, BENCH_F)
    emit("forest_knn_bench", b=cfg["b_bench"], k=K, max_frontier=BENCH_F,
         ms_per_cohort=bench_times, launches_per_call=knn_launches,
         kernel_vs_plain_bitwise=True, overflow_share=float(ovf_a.float().mean()))

    Qb = noisy_queries(cfg["b_exact"])
    tried = {}
    for Fx in cfg["exact_fs"]:
        tried[Fx] = float(any_overflow(forest, Qb, Fx).float().mean())
        if tried[Fx] == 0.0:
            break
    F_exact = Fx
    db, ib = fd.forest_knn(forest, Qb, k=K, max_frontier=F_exact)
    exact_times = [wall(lambda: fd.forest_knn(forest, Qb, k=K, max_frontier=F_exact))[1]
                   * 1e3 for _ in range(cfg["timing_reps"])]
    dq, iq = fd.forest_knn(forest, Qb, k=K, max_frontier=F_exact,
                           _scorer=frontier_scores_torch)
    check(torch.equal(db, dq) and torch.equal(ib, iq),
          "forest_knn exact: kernel and plain paths differ")
    (sd, si), scan_launches = per_call(lambda: sliced_scan(Xd, Qb, K + 1))
    sd1, si1 = fd.brute_force_knn(Xd, Qb, k=K + 1, device=device)
    check(torch.equal(sd, sd1) and torch.equal(si, si1),
          "the sharded scan differs from the one-device scan")
    n_ok, n_ids = check_exact(db, ib, any_overflow(forest, Qb, F_exact), sd, si,
                              lambda i: i, "forest_knn exact")
    scan_times = [wall(lambda: sliced_scan(Xd, Qb, K + 1))[1] * 1e3
                  for _ in range(cfg["timing_reps"])]
    prof_rows = {}
    if on_card:
        from torch.autograd import DeviceType
        for label, Q, Fx, wall_ms in (("bench", Qa, BENCH_F, bench_times),
                                      ("exact", Qb, F_exact, exact_times)):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                fd.forest_knn(forest, Q, k=K, max_frontier=Fx)
                torch.cuda.synchronize()
            kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
            kern.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
            busy = sum(ev.self_device_time_total for ev in kern) / 1e3
            med = float(np.median(wall_ms))
            prof_rows[label] = dict(
                wall_ms_median=med, device_busy_ms=busy,
                device_idle_share=max(0.0, 1.0 - busy / med),
                kernels=[dict(name=ev.key[:72], ms=ev.self_device_time_total / 1e3,
                              calls=ev.count) for ev in kern[:10]])
    emit("forest_knn_exact", b=cfg["b_exact"], k=K, overflow_share_by_F=tried,
         max_frontier=F_exact, no_overflow=tried[F_exact] == 0.0,
         ms_per_cohort=exact_times, kernel_vs_plain_bitwise=True,
         rows_checked_bitwise=n_ok, rows_ids_checked=n_ids,
         sharded_scan=dict(n_shards=S, ms=scan_times, launches_per_call=scan_launches,
                           equals_one_device_scan=True),
         profile=prof_rows)

    # ---------------------------------------------------------------- perquery
    t0 = fd.unstack_forest(forest)[0]
    pq_rows = {}
    for label, Q, Fx in (("bench", Qa, BENCH_F), ("exact", Qb, F_exact)):
        pq, pq_s = wall(lambda: smtree._knn_perquery(t0, Q, K, Fx, float("inf")))
        co, co_s = wall(lambda: smtree._knn_cohort(t0, Q, float("inf"), k=K, F=Fx,
                                                   height=height))
        pq_rows[label] = dict(
            b=Q.shape[0], max_frontier=Fx, ms=pq_s * 1e3, cohort_ms=co_s * 1e3,
            overflow_share=float(pq.overflow.float().mean()),
            cohort_overflow_share=float(co.overflow.float().mean()),
            dist_evals_per_query=float(pq.dist_evals.float().mean()),
            page_hits_per_query=float(pq.page_hits.float().mean()))
        if label == "bench":
            continue
        ok = ~(pq.overflow | co.overflow)
        check(bool(ok.any()), f"per-query {label}: every row overflowed")
        check(torch.equal(pq.dists[ok], co.dists[ok]),
              f"per-query {label}: dists differ from the cohort engine")
        # ids where a row's k distances are distinct (ties may pick either)
        untied = ok & (pq.dists[:, 1:] != pq.dists[:, :-1]).all(1)
        check(bool(untied.any()), f"per-query {label}: no row with distinct distances")
        check(torch.equal(pq.ids[untied], co.ids[untied]),
              f"per-query {label}: ids differ from the cohort engine")
        pq_rows[label].update(rows_checked=int(ok.sum()),
                              rows_ids_checked=int(untied.sum()))
    emit("forest_perquery", shard=0, k=K, results=pq_rows)

    # ---------------------------------------------------------------- mutations
    mrng = np.random.default_rng(12)
    n_ins, n_del = cfg["n_insert"], cfg["n_delete"]
    new_ids = np.arange(n, n + n_ins)
    ins_x = np.clip(X[mrng.integers(0, n, n_ins)] + mrng.normal(0, 0.01, (n_ins, dim)),
                    0, 1).astype(np.float32)
    victims = mrng.choice(n, n_del, replace=False)
    order = mrng.permutation(n_ins + n_del)
    ops = np.concatenate([np.full(n_ins, smtree.OP_INSERT),
                          np.full(n_del, smtree.OP_DELETE)])[order].astype(np.int32)
    oids = np.concatenate([new_ids, victims])[order].astype(np.int32)
    xs = np.vstack([ins_x, X[victims]])[order]
    owner = (oids % S).astype(np.int32)
    # the stream plane's two planes start from the forest as it is now
    base = fd.unstack_forest(smtree.clone_tree(forest))
    replay = smtree.clone_tree(forest)
    (_, st), mut_s = wall(lambda: fd.forest_apply_mutations(
        forest, ops, xs, oids, owner, validate=True))
    st = st.cpu().numpy()
    # the same log one row at a time through the fast paths, on the owner
    shards = fd.unstack_forest(replay)
    xs_d = torch.from_numpy(xs).to(dev)
    want = np.zeros_like(st)
    t1 = time.perf_counter()
    for r in range(len(ops)):
        t = shards[owner[r]]
        if ops[r] == smtree.OP_INSERT:
            _, fits, _ = smtree.insert_fast(t, xs_d[r], int(oids[r]))
            want[r] = smtree.ST_APPLIED if fits else smtree.ST_OVERFLOW
        else:
            _, found, under, _ = smtree.delete_fast(t, xs_d[r], int(oids[r]))
            want[r] = (smtree.ST_NOTFOUND if not found else
                       smtree.ST_UNDERFLOW if under else smtree.ST_APPLIED)
    one_s = time.perf_counter() - t1
    check(np.array_equal(st, want), "cohort statuses differ from the one-row replay")
    for f in smtree.ARRAY_FIELDS:
        check(torch.equal(getattr(forest, f), getattr(replay, f)),
              f"forest field {f} differs from the one-row replay")
    del replay, shards, forest
    scan_st = st
    st, fronts, forest = stream_planes(base, ops, xs, oids, owner, device, wall)
    applied = st == smtree.ST_APPLIED
    check(bool(np.isin(st, (smtree.ST_APPLIED, smtree.ST_NOTFOUND)).all()),
          "a row of the stream planes was left unresolved")
    # rows the fronts left to the host plane (a blocked split chain)
    escalations = fronts["stacked"]["escalated_rows"]
    # the stored rows of live ids, owner-routed
    gone = set(oids[applied & (ops == smtree.OP_DELETE)].tolist())
    placed = oids[applied & (ops == smtree.OP_INSERT)]
    live_old = np.array([o for o in mrng.choice(n, 2 * cfg["n_extract"], replace=False)
                         if o not in gone][:cfg["n_extract"] // 2])
    ex_ids = np.concatenate([live_old, placed[:cfg["n_extract"] - len(live_old)]])
    vec_of = dict(zip(new_ids.tolist(), ins_x))
    ex_want = np.stack([X[o] if o < n else vec_of[o] for o in ex_ids.tolist()])
    (ev, ef), ex_s = wall(lambda: fd.forest_extract_objects(forest, ex_ids, ex_ids % S))
    check(bool(ef.all()), "forest_extract_objects missed a live id")
    check(torch.equal(ev, torch.from_numpy(ex_want).to(dev)),
          "forest_extract_objects differs from the stored rows")
    # the exact forest kNN again, against a scan of the live set
    keep = np.ones(n, bool)
    keep[sorted(gone)] = False
    live_ids = torch.from_numpy(np.concatenate([np.nonzero(keep)[0], placed])).to(dev)
    Xlive = torch.from_numpy(np.vstack([X[keep], np.stack([vec_of[o] for o in
                                                           placed.tolist()])])).to(dev)
    Qr = torch.cat([Qb[:cfg["b_recheck"] // 2],
                    torch.from_numpy(ins_x[:cfg["b_recheck"] // 2]).to(dev)])
    dr, ir = fd.forest_knn(forest, Qr, k=K, max_frontier=F_exact)
    sd, si = fd.brute_force_knn(Xlive, Qr, k=K + 1, device=device)
    n_ok, n_ids = check_exact(dr, ir, any_overflow(forest, Qr, F_exact), sd, si,
                              lambda i: live_ids[i], "forest_knn after mutations")
    emit("forest_mutations", inserts=n_ins, deletes=n_del, seconds=mut_s,
         ms_per_row=mut_s * 1e3 / len(ops), one_row_replay_seconds=one_s,
         statuses={name: int((scan_st == code).sum()) for name, code in (
             ("applied", smtree.ST_APPLIED), ("overflow", smtree.ST_OVERFLOW),
             ("underflow", smtree.ST_UNDERFLOW), ("notfound", smtree.ST_NOTFOUND))},
         fronts=fronts, escalation_rows_left=escalations, replay_bitwise=True,
         extract=dict(ids=len(ex_ids), seconds=ex_s, bitwise=True),
         recheck_rows_bitwise=n_ok, recheck_rows_ids=n_ids,
         n_objects=int(sum(t.n_objects for t in fd.unstack_forest(forest))))

    launches = launch_counts()
    emit("forest_path_launches", **launches)
    if on_card:
        for name, c in launches.items():
            check(c > 0, f"kernel {name} never launched on the forest path")
    return dict(launches=launches, knn=knn_launches, scan=scan_launches)


def stream_planes(trees, ops, xs, oids, owner, device, wall):
    """The mutation log through both planes of ``StreamingForest`` from the
    same shards: the stacked plane (the forest stacked on the card: the
    scan front, then the overflow rows through ``forest_apply_splits`` in
    ``split_chunks`` widths, stopping at a chunk that blocked, then the
    underflow rows through ``forest_apply_merges`` in ``merge_chunks``
    widths) and the host plane (per-shard batchers: the batched scan and
    the device passes, shard by shard).  Statuses and every shard held
    bitwise between the planes; the rows routed as ``owner``.  Returns
    (statuses, a report, the stacked plane's forest)."""
    import numpy as np

    from repro_torch.core import smtree
    from repro_torch.stream import StreamingForest, tree_digest

    report = {}
    planes = {}
    for name, mesh in (("stacked", device), ("host", None)):
        sf = StreamingForest(trees, mesh=mesh)
        check(np.array_equal(sf.route(ops, oids), owner), f"{name}: routing differs")
        res, sec = wall(lambda: sf.apply(ops, xs, oids))
        planes[name] = (sf, res)
        report[name] = dict(seconds=sec, ms_per_row=sec * 1e3 / len(ops),
                            split_rows=res.n_split, merge_rows=res.n_merge,
                            escalated_rows=res.n_escalated)
    (sf, res), (hf, hres) = planes["stacked"], planes["host"]
    check(np.array_equal(res.statuses, hres.statuses), "the planes' statuses differ")
    check(tree_digest(sf.trees) == tree_digest(hf.trees), "the planes' shards differ")
    report.update(planes_bitwise=True, n_shards=sf.n_shards)
    st = res.statuses.copy()
    return st, report, sf.stacked()


def run_lm(cfg: dict, device: str):
    """The kNN-LM serving slice: its kernels against their plain versions
    (outside the launch counts), then its main path with the counts zeroed
    just before and read just after, then the replayed frontiers.  Returns
    (what the stream phases S1 and S3 need: the weights, a copy of the
    datastore taken before its eviction, ...; the slice's rows of the
    ``kernels`` line)."""
    import numpy as np
    import torch
    import torch.nn.functional as Fnn

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import smtree
    from repro_torch.core.engine import SMTreeEngine
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.distance import (pairwise_distance_prune,
                                              pairwise_distance_prune_torch)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_torch)
    from repro_torch.kernels.frontier import (frontier_scores,
                                              frontier_scores_torch)
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.transformer import hidden_states
    from repro_torch.roofline.counts import distance_work, flash_work
    from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore
    from repro_torch.serve.serve_step import make_prefill_step

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, time_ms, wall = timers(on_card)
    gen = torch.Generator(device=dev).manual_seed(7)
    reps = cfg["timing_reps"]

    def free():
        if on_card:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    # the frontier scorer at wide rows (kNN-LM keys are d_model wide)
    b, F, cap, N = cfg["wide_b"], cfg["wide_F"], cfg["wide_cap"], cfg["wide_N"]
    wide_rows = {}
    for dim in cfg["wide_dims"]:
        vecs = torch.randn((N, cap, dim), generator=gen, device=dev)
        valid = torch.rand((N, cap), generator=gen, device=dev) < 0.8
        leaf = (torch.rand((N,), generator=gen, device=dev) < 0.5)[:, None]
        iv, lv = valid & ~leaf, valid & leaf
        fids = torch.randint(0, N, (b, F), generator=gen, device=dev, dtype=torch.int32)
        fids[torch.rand((b, F), generator=gen, device=dev) < 0.1] = -1
        queries = torch.randn((b, dim), generator=gen, device=dev)
        for metric, scale in (("d_inf", 5.0), ("l2", (2.0 * dim) ** 0.5),
                              ("l1", 1.128 * dim)):
            # radii and parent distances around the metric's distance scale,
            # so the filter keeps some entries and drops others
            u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
            radius = u(N, cap) * 0.05 * scale
            filt = dict(pdist=(1 + 0.15 * torch.randn((N, cap), generator=gen,
                                                      device=dev)).abs() * scale,
                        qpd=(1 + 0.15 * torch.randn((b, F), generator=gen,
                                                    device=dev)).abs() * scale,
                        rq=u(b) * 0.1 * scale)
            args = (fids, queries, vecs, radius, iv, lv)
            for prune in (False, True):
                kw = dict(metric=metric, **(filt if prune else {}))
                got = frontier_scores(*args, **kw)
                want = frontier_scores_torch(*args, **kw)
                sync()
                for name, g, w in zip(("dmax", "score", "leaf_d", "dq"), got, want):
                    check(torch.equal(g, w), f"wide frontier dim={dim} {metric} "
                                             f"prune={prune} {name} not bitwise")
                row = dict(bitwise=True)
                if dim in cfg["wide_timed"]:
                    nbytes, nops, n_live = frontier_traffic(fids, queries, want, cap, prune)
                    bms, by = bound(nbytes, nops)
                    row.update(ms=time_ms(lambda: frontier_scores(*args, **kw)),
                               plain_ms=time_ms(lambda: frontier_scores_torch(*args, **kw),
                                                iters=3, warmup=1),
                               bound_ms=bms, bound_by=by, bytes=nbytes, ops=nops,
                               live_evals=n_live)
                wide_rows[f"{dim}/{metric}/{'prune' if prune else 'plain'}"] = row
                del got, want
        del vecs, queries, fids
        free()
    emit("kernel_frontier_wide", shapes=dict(b=b, F=F, cap=cap, N=N,
                                             dims=list(cfg["wide_dims"]),
                                             timed=list(cfg["wide_timed"])),
         bitwise=True, results=wide_rows)

    # ---------------------------------------------------------------- 8
    flash_rows = {}
    for name, (fb, h, hk, sq, sk, d, causal, dt) in cfg["flash_cases"].items():
        dtype = getattr(torch, dt)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
        q, k, v = rnd(fb, h, sq, d), rnd(fb, hk, sk, d), rnd(fb, hk, sk, d)
        got = flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention_torch(q, k, v, causal=causal)
        sync()
        tol = 2e-4 if dt == "float32" else 1e-2
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(got.dtype == dtype and got.shape == q.shape, f"flash {name}: dtype/shape")
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"flash {name}: beyond {tol} (max abs err {err})")
        row = dict(shape=[fb, h, hk, sq, sk, d], causal=causal, dtype=dt,
                   max_abs_err=err, tol=tol)
        if name.startswith(("path", "whisper")):
            # 4 d operations per visible (query, key) pair, bottom-right causal
            nops, nbytes = flash_work(fb, h, hk, sq, sk, d, causal, q.element_size())
            bms, by = flash_bound(nbytes, nops, dt)
            row.update(ms=time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal),
                                  iters=10),
                       plain_ms=time_ms(lambda: flash_attention_torch(q, k, v, causal=causal),
                                        iters=3, warmup=1),
                       # SDPA's causal mask is top-left: the same function
                       # only where sq == sk or there is no mask
                       library_ms=(time_ms(lambda: Fnn.scaled_dot_product_attention(
                           q, k, v, is_causal=causal), iters=10)
                           if on_card and (sq == sk or not causal) else None),
                       bound_ms=bms, bound_by=by,
                       f32_cuda_core_bound_ms=bound(nbytes, nops)[0],
                       flops=nops, bytes=nbytes)
        flash_rows[name] = row
        del q, k, v, got, want, diff
        free()
    emit("kernel_flash", results=flash_rows,
         library="torch.nn.functional.scaled_dot_product_attention (sq == sk or "
                 "non-causal)")

    # ---------------------------------------------------------------- 9
    nq, ne, d = cfg["prune_nq"], cfg["prune_ne"], cfg["prune_d"]
    q = torch.rand((nq, d), generator=gen, device=dev)
    e = torch.rand((ne, d), generator=gen, device=dev)
    prune_rows = {}
    for metric, (lo, hi) in (("d_inf", (0.0, 0.6)),
                             ("sqeuclidean", (0.1 * d ** 0.5, 0.35 * d ** 0.5)),
                             ("ip", (-0.2 * d, -0.05 * d))):
        r_q = lo + (hi - lo) * torch.rand((nq,), generator=gen, device=dev)
        r_e = lo + (hi - lo) * torch.rand((ne,), generator=gen, device=dev)
        gd, gm = pairwise_distance_prune(q, e, r_q, r_e, metric)
        wd, wm = pairwise_distance_prune_torch(q, e, r_q, r_e, metric)
        sync()
        err = float((gd - wd).abs().max())
        check(bool(((gd - wd).abs() <= 1e-5 + 1e-5 * wd.abs()).all()),
              f"prune {metric}: distances beyond 1e-5 (max abs err {err})")
        true_d = wd.clamp_min(0).double().sqrt() if metric == "sqeuclidean" else wd.double()
        decided = (true_d - (r_q[:, None] + r_e[None, :]).double()).abs() > 1e-6
        check(torch.equal(gm[decided], wm[decided]), f"prune {metric}: masks differ")
        nops, nbytes = distance_work(nq, ne, d, prune=True)
        bms, by = bound(nbytes, nops)
        kernel = lambda: pairwise_distance_prune(q, e, r_q, r_e, metric)
        prune_rows[metric] = dict(
            ms=time_ms(kernel), device_ms=device_ms(kernel) if on_card else None,
            plain_ms=time_ms(lambda: pairwise_distance_prune_torch(q, e, r_q, r_e, metric),
                             iters=5),
            library_ms=None, bound_ms=bms, bound_by=by, max_abs_err=err,
            undecided=int((~decided).sum()), mask_differs_undecided=int(
                (gm[~decided] != wm[~decided]).sum()),
            survive_share=float(gm.float().mean()))
        del gd, gm, wd, wm, true_d, decided
    emit("kernel_distance_prune", shapes=dict(nq=nq, ne=ne, d=d), results=prune_rows)
    del q, e
    free()

    # ---------------------------------------------------------------- 10-11
    # the main path: counts zeroed here and read after the datastore phase
    frontier_scores.launches = 0
    frontier_scores.pruned_launches = 0
    frontier_scores.wide_launches = 0
    flash_attention_fwd.launches = 0

    def counts():
        return dict(flash=flash_attention_fwd.launches,
                    frontier=frontier_scores.launches,
                    frontier_pruned=frontier_scores.pruned_launches,
                    frontier_wide=frontier_scores.wide_launches)

    def delta(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    mcfg = smoke_config(cfg["arch"]) if cfg["smoke"] else get_config(cfg["arch"])
    params, init_s = wall(lambda: M.init_params(mcfg, 0, device=device))
    n_params = M.param_count(params)
    check(n_params == mcfg.param_count + mcfg.d_model,
          f"{n_params} parameters vs cfg.param_count {mcfg.param_count} "
          "(+ the final norm's scale, which it leaves out)")
    B, S, V = cfg["prefill_b"], cfg["prefill_s"], mcfg.padded_vocab
    tokens = torch.from_numpy(synth_batch(DataConfig(
        vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B), 0,
        with_labels=False)["tokens"]).to(dev)
    prefill = make_prefill_step(mcfg)
    c0 = counts()
    logits, prefill_s = wall(lambda: prefill(params, {"tokens": tokens}))
    per_forward = delta(c0)["flash"]
    if on_card:
        check(per_forward == mcfg.n_layers,
              f"{per_forward} flash launches in one forward, not {mcfg.n_layers}")
    again = [wall(lambda: prefill(params, {"tokens": tokens}))[1] for _ in range(2)]
    plain_logits, plain_s = wall(lambda: make_prefill_step(
        mcfg, _attention=flash_attention_torch)(params, {"tokens": tokens}))
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V),
          "prefill logits: shape or non-finite values")
    err = float((logits - plain_logits).abs().max())
    top = float(plain_logits.abs().max())
    check(err <= 1e-3 * top, f"prefill logits: kernel vs plain {err} > 1e-3 x {top}")
    argmax_eq = torch.equal(logits[:, -1].argmax(-1), plain_logits[:, -1].argmax(-1))
    check(argmax_eq, "prefill: last-position argmax differs from the plain path")
    del logits, plain_logits
    free()

    # where the time goes: device time by kernel of one prefill forward
    if on_card:
        prefill_prof = profile_device(lambda: prefill(params, {"tokens": tokens}),
                                      float(np.median(again)) * 1e3)

    args = serve.parser().parse_args(cfg["serve_argv"] + ["--device", device])
    store, store_s = wall(lambda: serve._build_store(args, mcfg, device))
    c0 = counts()
    toks, timing = serve.serve_loop(args, mcfg, params, store)
    serve_counts = delta(c0)
    check(toks.shape == (args.batch, args.steps + 1)
          and bool(((toks >= 0) & (toks < V)).all()), "serve: bad tokens")
    emit("lm_serve", arch=mcfg.name, n_layers=mcfg.n_layers, d_model=mcfg.d_model,
         heads=[mcfg.n_heads, mcfg.n_kv_heads], d_ff=mcfg.d_ff, vocab=mcfg.vocab_size,
         dtype=mcfg.param_dtype, params=n_params, cfg_param_count=mcfg.param_count,
         init_seconds=init_s,
         prefill=dict(b=B, s=S, ms=[prefill_s * 1e3] + [t * 1e3 for t in again],
                      plain_attention_ms=plain_s * 1e3,
                      flash_launches_per_forward=per_forward,
                      max_abs_logit_err=err, max_abs_logit=top,
                      last_argmax_equal=argmax_eq,
                      flash_share_of_device_time=(prefill_prof["flash_share_of_busy"]
                                                  if on_card else None)),
         serve=dict(batch=args.batch, prompt_len=args.prompt_len, steps=args.steps,
                    knn=True, lam=args.lam, store_keys=len(store.values),
                    store_build_seconds=store_s,
                    prompt_feed_ms_per_token=timing["prefill_s"] * 1e3 / args.prompt_len,
                    ms_per_decode_step=timing["ms_per_step"],
                    frontier_launches_per_step=serve_counts["frontier"] / args.steps,
                    launches=serve_counts, sample=toks[0][:12].tolist()))

    # and of one kNN-LM decode step
    if on_card:
        emit("profile_lm", prefill=prefill_prof,
             decode_step_knn=profile_decode_knn(params, mcfg, store, toks[:, 0], args.lam))
    del store, tokens
    free()

    # the datastore: keys are hidden states of 32 x 2048 synthetic tokens
    L, n_seq, chunk = cfg["ds_len"], cfg["ds_seqs"], cfg["ds_chunk"]
    D = mcfg.d_model
    batch = synth_batch(DataConfig(vocab_size=mcfg.vocab_size, seq_len=L,
                                   global_batch=n_seq), 100)
    keys = np.empty((n_seq * L, D), np.float32)
    t0 = time.perf_counter()
    for i in range(0, n_seq, chunk):
        h = hidden_states(params, mcfg, {"tokens": torch.from_numpy(
            batch["tokens"][i:i + chunk]).to(dev)})
        keys[i * L:(i + chunk) * L] = h.reshape(-1, D).cpu().numpy()
    tap_s = time.perf_counter() - t0
    vals = batch["labels"].reshape(-1)
    held = synth_batch(DataConfig(seed=1, vocab_size=mcfg.vocab_size, seq_len=L,
                                  global_batch=chunk), 0)
    hq = hidden_states(params, mcfg, {"tokens": torch.from_numpy(held["tokens"]).to(dev)})
    pick = np.random.default_rng(3).choice(chunk * L, max(cfg["ret_bs"]), replace=False)
    Q = hq.reshape(-1, D)[torch.from_numpy(pick).to(dev)].contiguous()
    # new keys for the stream phase's add batches (S1)
    add_keys = hq.reshape(-1, D)[:2 * cfg["ds_evict"]].cpu().numpy()
    add_vals = held["labels"].reshape(-1)[:2 * cfg["ds_evict"]].astype(np.int32)
    del hq
    store = KnnLmDatastore(KnnLmConfig(k=8, lam=0.3, metric="l2", capacity=32,
                                       max_frontier=128), D, device=device)
    _, build_s = wall(lambda: store.build(keys, vals))
    tree = store.engine.tree
    tree_info = dict(keys=len(vals), dim=D, height=int(tree.height),
                     n_nodes=int(tree.n_nodes), max_nodes=tree.max_nodes,
                     page_bytes=tree.vecs.numel() * 4)

    # the first retrieval's frontiers, as the descent passes them to the
    # scorer (through the plain scorer: no launch), for phase 12
    captured, pages = {}, {}

    def retrieval(tag, capture=False):
        out = {}
        for rb in cfg["ret_bs"]:
            q = Q[:rb]
            c0 = counts()
            res = store.retrieve(q)
            launches = delta(c0)
            ref = store.retrieve(q, _scorer=(recorder(captured.setdefault(f"b{rb}", []), pages)
                                             if capture else frontier_scores_torch))
            for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
                check(torch.equal(getattr(res, f), getattr(ref, f)),
                      f"datastore {tag} b={rb}: kernel and plain descents differ in {f}")
            ms = [wall(lambda: store.knn_logits(q, V))[1] * 1e3 for _ in range(reps)]
            lp = store.knn_logits(q, V)
            check(lp.shape == (rb, V) and bool(torch.isfinite(lp).all()),
                  f"datastore {tag}: kNN log-probs")
            out[f"b{rb}"] = dict(
                k=8, max_frontier=128, knn_logits_ms=ms, bitwise_vs_plain=True,
                overflow_share=float(res.overflow.float().mean()),
                dist_evals_per_query=float(res.dist_evals.float().mean()),
                page_hits_per_query=float(res.page_hits.float().mean()),
                frontier_launches=launches["frontier"],
                frontier_pruned_launches=launches["frontier_pruned"],
                min_id=int(res.ids.min()))
        return out

    before = retrieval("built", capture=True)
    n_ev, n_eb = cfg["ds_evict"], cfg["ds_evict_before"]
    # copies for phase 11b and for the stream phase (S1), taken before the
    # eviction (no launch)
    batched = smtree.clone_tree(store.engine.tree)
    s1_store = copy.copy(store)
    s1_store.engine = SMTreeEngine(smtree.clone_tree(store.engine.tree))
    nodes_before = int(store.engine.tree.alive.sum())
    evicted, evict_s = wall(lambda: store.evict_before(n_eb))
    nodes_after = int(store.engine.tree.alive.sum())
    check(evicted == n_eb, f"evicted {evicted} of {n_eb}")
    _, val_s = wall(store.engine.validate)
    check(store.engine.n_objects == len(vals) - n_eb, "datastore count after eviction")
    after = retrieval("after eviction")
    check(all(r["min_id"] >= n_eb or r["min_id"] == -1 for r in after.values()),
          "an evicted key came back")
    emit("knnlm_datastore", hidden_state_tap_seconds=tap_s, build_seconds=build_s,
         tree=tree_info, retrieval=before, evicted=evicted, evict_seconds=evict_s,
         evict_before_cut=(f"{n_eb} ids, not the batched paths' {n_ev}: the one-Delete-"
                           "at-a-time eviction is cut to keep the run under ~560 s"
                           if n_eb < n_ev else None),
         alive_nodes_before_after_evict=[nodes_before, nodes_after],
         validate=True, validate_seconds=val_s, retrieval_after_evict=after)
    path = counts()
    emit("lm_path_launches", **path)
    if on_card:
        check(path["flash"] > 0, "the flash kernel never launched on the main path")
        check(path["frontier_wide"] > 0 and path["frontier_wide"] == path["frontier"],
              "the wide frontier variant did not carry the datastore's retrieval")
        check(path["frontier_pruned"] > 0 and path["frontier"] > path["frontier_pruned"],
              "the wide frontier ran without or only with the parent filter")

    # ---------------------------------------------------------------- 11b
    # the same deletes as one cohort through the device passes, on the copy
    ev_ops = np.full(n_ev, smtree.OP_DELETE, np.int32)
    ev_ids = np.arange(n_ev, dtype=np.int32)
    with split_merge_probe(sync) as probe:
        (_, st_ev), bev_s = wall(lambda: smtree.apply_mutations(
            batched, ev_ops, store.keys[:n_ev], ev_ids))
    st_ev = st_ev.cpu().numpy()
    check(bool(np.isin(st_ev, (smtree.ST_APPLIED, smtree.ST_MERGE)).all()),
          "batched eviction: a delete did not apply")
    beng = SMTreeEngine(batched)
    _, bval_s = wall(beng.validate)

    def live_ids(t):
        return torch.sort(t.oid[t.valid & (t.alive & t.is_leaf)[:, None]]).values

    # what evict_before(n_ev) leaves: every id from n_ev on
    want_live = torch.arange(n_ev, len(vals), dtype=torch.int32, device=dev)
    check(torch.equal(live_ids(batched), want_live),
          "batched eviction: the live ids differ from evict_before's")
    if n_eb == n_ev:
        check(torch.equal(live_ids(store.engine.tree), want_live),
              "evict_before: the live ids differ")
    bret = {}
    for rb in cfg["ret_bs"]:
        q = Q[:rb]
        c0 = counts()
        res = beng.knn(q, k=8, max_frontier=128)
        launches = delta(c0)
        ref = beng.knn(q, k=8, max_frontier=128, _scorer=frontier_scores_torch)
        for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
            check(torch.equal(getattr(res, f), getattr(ref, f)),
                  f"batched eviction b={rb}: kernel and plain descents differ in {f}")
        bret[f"b{rb}"] = dict(bitwise_vs_plain=True, frontier_launches=launches["frontier"],
                              overflow_share=float(res.overflow.float().mean()),
                              min_id=int(res.ids.min()))
    emit("knnlm_batched_evict", deletes=n_ev, seconds=bev_s, evict_before_seconds=evict_s,
         evict_before_ids=n_eb,
         not_bitwise_to_evict_before="a cohort orders its structure edits "
         "differently from one Delete at a time",
         statuses={"applied": int((st_ev == smtree.ST_APPLIED).sum()),
                   "merge": int((st_ev == smtree.ST_MERGE).sum())},
         fast_scan_seconds=bev_s - probe["merge_seconds"] - probe["split_seconds"],
         merge_pass=dict(seconds=probe["merge_seconds"], rows=probe["merge_rows"],
                         ms_per_row=probe["ms_per_merge_row"], merges=probe["merges"],
                         redistributions=probe["redistributions"],
                         levels_collapsed=probe["levels_collapsed"]),
         alive_nodes=int(batched.alive.sum()), height=int(batched.height),
         validate=True, validate_seconds=bval_s, live_ids_equal_evict_before=True,
         retrieval=bret)
    ctx = dict(params=params, mcfg=mcfg, store=s1_store, Q=Q, V=V, n_ev=n_ev,
               evicted_live=want_live, add_keys=add_keys,
               add_vals=add_vals, lm_ms_per_step=timing["ms_per_step"], lm_toks=toks)
    del store, keys, batched, beng
    free()

    # ---------------------------------------------------------------- 12
    replay = frontier_replay(captured, pages, on_card)
    emit("frontier_replay", store_keys=len(vals), k=8, max_frontier=128,
         dim=D, metric="l2", results=replay)
    del captured, pages
    free()

    # every frontier launch of this path is wide (checked above on the card):
    # the unfiltered ones score the root level, the filtered ones the rest
    # the rows' ms and bound are taken at the first served width; the other
    # served widths' under ``by_dim``
    d0 = cfg["wide_timed"][0]
    wide_u, wide_p = (wide_rows[f"{d0}/l2/{m}"] for m in ("plain", "prune"))
    by_dim = lambda m: {str(d): {k: wide_rows[f"{d}/l2/{m}"][k]
                                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                        for d in cfg["wide_timed"][1:]}
    ret0 = before[f"b{cfg['ret_bs'][0]}"]
    step_u = (serve_counts["frontier"] - serve_counts["frontier_pruned"]) / args.steps
    step_p = serve_counts["frontier_pruned"] / args.steps
    fl = flash_rows["path_f32"]
    pr = prune_rows["d_inf"]
    return ctx, [
        dict(name="frontier_scores[wide]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:109",
             launches=path["frontier"] - path["frontier_pruned"],
             launches_per_pass={"decode_step_knn": step_u, "datastore_retrieval":
                                ret0["frontier_launches"] - ret0["frontier_pruned_launches"]},
             max_abs_err=0.0, ms=wide_u["ms"], plain_ms=wide_u["plain_ms"],
             bound_ms=wide_u["bound_ms"], bound_by=wide_u["bound_by"], library_ms=None,
             dim=d0, by_dim=by_dim("plain")),
        dict(name="frontier_scores[wide,parent_prune]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:121",
             launches=path["frontier_pruned"],
             launches_per_pass={"decode_step_knn": step_p,
                                "datastore_retrieval": ret0["frontier_pruned_launches"]},
             max_abs_err=0.0, ms=wide_p["ms"], plain_ms=wide_p["plain_ms"],
             bound_ms=wide_p["bound_ms"], bound_by=wide_p["bound_by"], library_ms=None,
             dim=d0, by_dim=by_dim("prune")),
        dict(name="pairwise_distance_prune", route="cuda",
             source="src/repro_torch/kernels/csrc/distance.cu",
             replaces="src/repro/kernels/distance.py:62",
             launches=0, launches_per_pass={}, max_abs_err=pr["max_abs_err"], ms=pr["ms"],
             device_ms=pr["device_ms"], plain_ms=pr["plain_ms"], bound_ms=pr["bound_ms"],
             bound_by=pr["bound_by"], library_ms=None),
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:38",
             launches=path["flash"],
             launches_per_pass={"prefill_forward": per_forward},
             max_abs_err=fl["max_abs_err"], ms=fl["ms"],
             plain_ms=fl["plain_ms"], bound_ms=fl["bound_ms"],
             bound_by=fl["bound_by"], library_ms=fl["library_ms"],
             f32_cuda_core_bound_ms=fl["f32_cuda_core_bound_ms"],
             by_shape={name: {k: row[k] for k in ("shape", "causal", "max_abs_err", "ms",
                                                  "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "f32_cuda_core_bound_ms")}
                       for name, row in flash_rows.items() if name.startswith("whisper")}),
    ]


STREAM_FULL = dict(
    # S1: the phase-11 store (65,536 x 2048, l2, capacity 32, F=128)
    ds_fs=(128, 512, 2048, 8192), ds_b=64,
    # S2: FOREST_FULL's 1,000,000 objects over 8 shards, the serve
    # launcher's skew settings (launch/serve.py:_build_store)
    forest=dict(n=1_000_000, dims=20, capacity=32, n_shards=8, drain=32_768,
                batch=4_096, both_planes=2, steps=32, snapshot_at=16, max_skew=1.3,
                min_objects=256, b_bench=1024, b_exact=256,
                exact_fs=(512, 1024, 2048, 4096, 8192, 16384)),
    # S3: launch/serve at full width (phase 10's b=4, prompt 32, 16 steps)
    serve_argvs={"knn_mutate": ["--knn", "--knn-mutate", "--obs"],
                 "knn_shards4": ["--knn", "--knn-mutate", "--knn-shards", "4", "--obs"]})


def stream_counts():
    from repro_torch.kernels.distance import pairwise_distance
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.frontier import frontier_scores
    return dict(frontier=frontier_scores.launches - frontier_scores.pruned_launches,
                frontier_pruned=frontier_scores.pruned_launches,
                frontier_wide=frontier_scores.wide_launches,
                distance=pairwise_distance.launches, flash=flash_attention_fwd.launches)


def zero_counts():
    from repro_torch.kernels.distance import pairwise_distance
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.frontier import frontier_scores
    frontier_scores.launches = frontier_scores.pruned_launches = 0
    frontier_scores.wide_launches = 0
    pairwise_distance.launches = flash_attention_fwd.launches = 0


def span_seconds(names) -> dict:
    """Seconds of each recorded obs span by name, in the order they ended."""
    from repro_torch import obs
    out = {n: [] for n in names}
    for sp in obs.RECORDER.spans():
        if sp["name"] in out:
            out[sp["name"]].append(sp["duration_s"])
    return out


def tree_bytes(t) -> int:
    from repro_torch.core.smtree import ARRAY_FIELDS
    return sum(getattr(t, f).numel() * getattr(t, f).element_size() for f in ARRAY_FIELDS)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def stream_datastore(ctx: dict, cfg: dict, device: str):
    """S1: the phase-11 datastore (a copy taken before its eviction) through
    ``enable_stream`` with a WAL: ``evict_batch`` of the ids that
    ``evict_before`` evicted, then ``add_batch`` of as many new keys, each
    against an epoch pinned before it; retrieval on the pinned epoch
    through the kernels against the plain scorer, with the overflow share
    by F; a snapshot through ``CheckpointManager``, two more batches, and
    ``StreamingEngine.restore`` + the WAL tail and a ``Replica`` tailing
    the same WAL, each reaching the live engine's (seq, digest)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import smtree
    from repro_torch.core.engine import SMTreeEngine
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.kernels.frontier import frontier_scores_torch
    from repro_torch.stream import (Replica, StreamingEngine, WriteAheadLog,
                                    ledger_digest, tree_digest)

    _, _, wall = timers(device == "cuda")
    store, Q, V, n_ev = ctx["store"], ctx["Q"], ctx["V"], ctx["n_ev"]
    root = tempfile.mkdtemp(prefix="chip_smoke_s1_")
    try:
        obs.reset()
        obs.enable()
        wal_dir, ck_dir = f"{root}/wal", f"{root}/ck"
        stream = store.enable_stream(wal_dir, ckpt=CheckpointManager(ck_dir, async_write=False))
        ds_fs, b = cfg["ds_fs"], cfg["ds_b"]
        with stream.epochs.reading() as pinned:
            share = {}
            for F in ds_fs:
                share[F] = float(smtree.knn(pinned, Q[:b], k=8, max_frontier=F)
                                 .overflow.float().mean())
                if share[F] == 0.0:
                    break
        exact_F = next((F for F, v in share.items() if v == 0.0), None)

        batches = {}

        def batch(name, fn):
            with stream.epochs.reading() as pinned:
                d0 = tree_digest(pinned)
                esc0 = obs.counter("stream.escalated_rows_total").value
                n, sec = wall(fn)
                resident = tree_bytes(pinned) + tree_bytes(stream.tree)
                check(tree_digest(pinned) == d0, f"S1 {name}: the pinned epoch changed")
            batches[name] = dict(rows=int(n), seconds=sec, resident_epoch_bytes=resident,
                                 escalated_rows=obs.counter("stream.escalated_rows_total")
                                 .value - esc0)

        batch("evict", lambda: store.evict_batch(np.arange(n_ev)))
        check(batches["evict"]["rows"] == n_ev, "S1: evict_batch removed too few")
        got = stream.tree
        check(torch.equal(torch.sort(got.oid[got.valid & (got.alive & got.is_leaf)[:, None]])
                          .values, ctx["evicted_live"]),
              "S1: the live ids differ from the evicted store's")
        _, val_s = wall(lambda: check(SMTreeEngine(stream.tree).validate(),
                                      "S1: validate after the eviction"))
        add_k, add_v = ctx["add_keys"], ctx["add_vals"]
        batch("add", lambda: len(store.add_batch(add_k[:n_ev], add_v[:n_ev])))
        spans = span_seconds(("mutation.wal_append", "mutation.apply", "mutation.publish"))
        for i, name in enumerate(("evict", "add")):
            batches[name].update({k.split(".")[1] + "_seconds": v[i] for k, v in spans.items()})
        _, copy_s = wall(lambda: smtree.clone_tree(stream.tree))

        retrieval = {}
        for rb in sorted({4, b}):
            q = Q[:rb]
            with stream.epochs.reading() as pinned:
                res = smtree.knn(pinned, q, k=8, max_frontier=128)
                ref = smtree.knn(pinned, q, k=8, max_frontier=128,
                                 _scorer=frontier_scores_torch)
            for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
                check(torch.equal(getattr(res, f), getattr(ref, f)),
                      f"S1 b={rb}: kernel and plain descents differ in {f}")
            lp = store.knn_logits(q, V)
            check(lp.shape == (rb, V) and bool(torch.isfinite(lp).all()), "S1: kNN log-probs")
            retrieval[f"b{rb}"] = dict(
                knn_logits_ms=[wall(lambda: store.knn_logits(q, V))[1] * 1e3 for _ in range(3)],
                overflow_share=float(res.overflow.float().mean()), bitwise_vs_plain=True)

        _, snap_s = wall(stream.snapshot)
        snap_bytes = dir_bytes(ck_dir)
        store.evict_batch(np.arange(n_ev, 2 * n_ev))
        store.add_batch(add_k[n_ev:], add_v[n_ev:])
        seq, digest = ledger_digest(stream)
        restored, restore_s = wall(lambda: StreamingEngine.restore(
            ck_dir, wal=WriteAheadLog(wal_dir), device=device))
        check(tree_digest(restored.tree) == digest, "S1: snapshot + WAL tail != the live engine")
        del restored
        rep, rep_s = wall(lambda: Replica.from_snapshot(ck_dir, wal_dir, device=device))
        _, poll_s = wall(lambda: rep.verify(seq, digest, timeout=600))
        del rep
        m = obs.REGISTRY.snapshot()
        emit("stream_datastore", keys=len(store.values), dim=store.dim, batch_rows=n_ev,
             batches=batches, copy_seconds=copy_s, validate_seconds=val_s,
             escalated_rows=m["stream.escalated_rows_total"],
             device_merges=m["stream.device_merges_total"],
             device_splits=m["stream.device_splits_total"],
             wal_bytes=m["wal.bytes_total"], wal_appends=m["wal.appends_total"],
             retrieval=retrieval, overflow_share_b64_by_F=share,
             smallest_exact_F_b64=exact_F, snapshot=dict(
                 bytes=snap_bytes, write_seconds=snap_s, restore_seconds=restore_s,
                 tail_batches=2, restore_equals_live=True),
             replica=dict(from_snapshot_seconds=rep_s, tail_seconds=poll_s, seq=seq,
                          digest_equal=True),
             pinned_epochs_unchanged=True, live_ids_equal_evict_before=True)
    finally:
        obs.disable()
        obs.reset()
        shutil.rmtree(root, ignore_errors=True)


def lm_serve_stream(ctx: dict, cfg: dict, device: str):
    """S3: ``launch/serve`` with ``--knn --knn-mutate --obs`` (and with a
    4-shard forest) on the phase-10 weights: ms per decode step beside
    phase 10's, and the ``[obs]`` snapshot's stream/wal/epoch rows."""
    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.obs.export import metrics_snapshot

    params, mcfg, V = ctx["params"], ctx["mcfg"], ctx["V"]
    runs = {}
    for name, argv in cfg["serve_argvs"].items():
        args = serve.parser().parse_args(argv + ["--device", device])
        obs.reset()
        obs.enable()
        try:
            store = serve._build_store(args, mcfg, device)
            c0 = stream_counts()
            toks, timing = serve.serve_loop(args, mcfg, params, store)
            c1 = stream_counts()
            snap = metrics_snapshot()
        finally:
            obs.disable()
            obs.reset()
        check(toks.shape == (args.batch, args.steps + 1)
              and bool(((toks >= 0) & (toks < V)).all()), f"S3 {name}: bad tokens")
        check(timing["mutations"] == 2 * args.batch * args.steps, f"S3 {name}: mutations")
        n_live = sum(t.n_objects for t in (store.stream.trees if args.knn_shards > 1
                                           else [store.stream.tree]))
        check(n_live == 2048, f"S3 {name}: {n_live} live keys, not 2048")
        rows = {k: v for k, v in snap["metrics"].items()
                if k.split(".")[0] in ("stream", "wal", "epoch")}
        ctx.setdefault("s3_ms_per_step", timing["ms_per_step"])
        runs[name] = dict(argv=argv, ms_per_decode_step=timing["ms_per_step"],
                          lm_serve_ms_per_decode_step=ctx["lm_ms_per_step"],
                          mutations=timing["mutations"], obs_rows=rows,
                          launches={k: c1[k] - c0[k] for k in c0})
        del store
    emit("lm_serve_stream", arch=mcfg.name, runs=runs,
         wal_rows="none: --knn-mutate runs without a WAL, as the reference's does")


def stream_forest(cfg: dict, device: str) -> dict:
    """S2: FOREST_FULL's objects over 8 shards as a ``StreamingForest``
    (incremental rebalancing, WAL and checkpoints): a delete stream that
    drains shard 0, ``maintenance()`` after each batch, the first batches
    through both planes (stacked and host) held bitwise; then the
    migration's steps, a snapshot between them and the crash drill
    (restore + WAL tail = the live forest); forest kNN on a pinned epoch
    through the kernels against the plain scorer and, at the smallest exact
    F, against ``brute_force_knn`` of the live set; one stop-the-world
    rebuild on the side, timed.  Returns the live forest, its objects, the
    live ids and the directory of its snapshot and WAL (``root``, which the
    caller removes; it is removed here only when the phase fails)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import distributed as fd
    from repro_torch.core import smtree
    from repro_torch.data.datagen import clustered
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.kernels.frontier import frontier_scores_torch
    from repro_torch.serve.frontend import pinned_knn
    from repro_torch.stream import (StreamingForest, WriteAheadLog, collect_stats,
                                    rebalance_shards, tree_digest)

    _, _, wall = timers(device == "cuda")
    c = cfg["forest"]
    n, S, dim = c["n"], c["n_shards"], c["dims"]
    X = clustered(n, dims=dim, seed=0)
    trees, build_s = wall(lambda: fd.build_forest_trees(X, S, capacity=c["capacity"],
                                                        metric="d_inf", device=device))
    root = tempfile.mkdtemp(prefix="chip_smoke_s2_")
    try:
        obs.reset()
        obs.enable()
        kw = dict(rebalance_mode="incremental", max_skew=c["max_skew"],
                  min_objects=c["min_objects"])
        sf = StreamingForest(trees, wal=WriteAheadLog(f"{root}/wal"),
                             ckpt=CheckpointManager(f"{root}/ck", async_write=False), **kw)
        other = StreamingForest(trees, mesh=device, **kw)
        rng = np.random.default_rng(21)
        drain = rng.choice(np.arange(0, n, S), c["drain"], replace=False).astype(np.int32)
        rows = []
        for i in range(c["drain"] // c["batch"]):
            ids = drain[i * c["batch"]:(i + 1) * c["batch"]]
            esc0 = obs.counter("stream.escalated_rows_total").value
            res, sec = wall(lambda: sf.delete_batch(X[ids], ids))
            check(bool((res.statuses == smtree.ST_APPLIED).all()), "S2: a delete did not apply")
            row = dict(seconds=sec, ms_per_row=sec * 1e3 / len(ids), merges=res.n_merge,
                       escalated=obs.counter("stream.escalated_rows_total").value - esc0)
            if i < c["both_planes"]:
                _, osec = wall(lambda: other.delete_batch(X[ids], ids))
                check(tree_digest(sf.trees) == tree_digest(other.trees),
                      f"S2 batch {i}: the stacked and host planes differ")
                row.update(stacked_plane_seconds=osec, planes_bitwise=True)
            _, msec = wall(sf.maintenance)
            row["maintenance_seconds"] = msec
            rows.append(row)
        del other
        check(sf.migration_active, "S2: the drained shard did not start a migration")
        plan = next(e["attrs"] for e in obs.RECORDER.events()
                    if e["name"] == "stream.migration_plan")
        skew_before = collect_stats(sf.trees).skew
        while sf.migration_active and sf.n_migration_steps < c["steps"]:
            sf.maintenance()
            if sf.n_migration_steps == c["snapshot_at"]:
                _, snap_s = wall(sf.snapshot)
                snap_bytes = dir_bytes(f"{root}/ck")
        steps = sf.n_migration_steps
        check(steps == c["steps"], f"S2: the plan ended after {steps} steps")
        skew_after = collect_stats(sf.trees).skew
        live_digest = tree_digest(sf.trees)
        restored, restore_s = wall(lambda: StreamingForest.restore(
            f"{root}/ck", wal=WriteAheadLog(f"{root}/wal"), device=device))
        check(tree_digest(restored.trees) == live_digest,
              "S2: restore between migration steps + WAL tail != the live forest")
        check(restored.owner == sf.owner, "S2: the restored ownership map differs")
        del restored
        pause = obs.histogram("rebalance.step_pause_s")
        m = obs.REGISTRY.snapshot()

        # forest kNN on a pinned epoch
        qrng = np.random.default_rng(22)
        gone = np.zeros(n, bool)
        gone[drain] = True
        live = np.nonzero(~gone)[0]

        def queries(m_):
            rows_ = live[qrng.integers(0, len(live), m_)]
            return torch.from_numpy((X[rows_] + qrng.normal(0, 0.01, (m_, dim)))
                                    .astype(np.float32)).to(device)

        Qa, Qb = queries(c["b_bench"]), queries(c["b_exact"])
        with sf.epochs.reading() as pinned:
            (da, ia), bench_s = wall(lambda: pinned_knn(pinned, Qa, k=K, max_frontier=BENCH_F))
            dp, ip = pinned_knn(pinned, Qa, k=K, max_frontier=BENCH_F,
                                _scorer=frontier_scores_torch)
            check(torch.equal(da, dp) and torch.equal(ia, ip),
                  "S2 forest kNN: kernel and plain paths differ")
            tried = {}
            for Fx in c["exact_fs"]:
                ovf = torch.stack([smtree.knn(t, Qb, k=K, max_frontier=Fx).overflow
                                   for t in pinned]).any(0)
                tried[Fx] = float(ovf.float().mean())
                if tried[Fx] == 0.0:
                    break
            (db, ib), exact_s = wall(lambda: pinned_knn(pinned, Qb, k=K, max_frontier=Fx))
        check(tried[Fx] == 0.0, "S2: every exact F overflowed")
        Xlive = torch.from_numpy(X[live]).to(device)
        sd, si = fd.brute_force_knn(Xlive, Qb, k=K + 1, device=device)
        live_t = torch.from_numpy(live).to(device)
        check(torch.equal(db, sd[:, :K]), "S2 exact forest kNN: dists differ from the scan")
        distinct = sd[:, K - 1] != sd[:, K]
        check(torch.equal(torch.sort(ib[distinct].long(), 1).values,
                          torch.sort(live_t[si[distinct, :K]], 1).values),
              "S2 exact forest kNN: ids differ from the scan")

        trees_now = sf.trees
        (rebuilt, moved, _), rebuild_s = wall(lambda: rebalance_shards(trees_now, seed=0))
        check(collect_stats(rebuilt).total == collect_stats(trees_now).total,
              "S2: the stop-the-world rebuild lost objects")
        emit("stream_forest", n=n, n_shards=S, build_seconds=build_s, batches=rows,
             rebalance_mode="incremental", max_skew=c["max_skew"],
             plan=dict(steps=plan["steps"], objects=plan["objects"], step_objects=64),
             migration=dict(steps_run=steps, objects_moved=sf.objects_migrated,
                            step_pause_ms_mean=pause.mean * 1e3,
                            step_pause_ms_p50=pause.percentile(50) * 1e3,
                            step_pause_ms_max=m["rebalance.step_pause_s.max"] * 1e3,
                            skew_at_plan=skew_before, skew_after=skew_after),
             crash_drill=dict(snapshot_after_step=c["snapshot_at"], snapshot_bytes=snap_bytes,
                              snapshot_seconds=snap_s, restore_seconds=restore_s,
                              restore_equals_live=True),
             escalated_rows=m["stream.escalated_rows_total"],
             wal_bytes=m["wal.bytes_total"],
             knn=dict(bench=dict(b=c["b_bench"], max_frontier=BENCH_F, ms=bench_s * 1e3,
                                 bitwise_vs_plain=True),
                      exact=dict(b=c["b_exact"], overflow_share_by_F=tried, max_frontier=Fx,
                                 ms=exact_s * 1e3, rows_checked=c["b_exact"],
                                 rows_ids_checked=int(distinct.sum()))),
             stop_world=dict(seconds=rebuild_s, moved=moved,
                             skew_after=collect_stats(rebuilt).skew))
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        obs.disable()
        obs.reset()
    return dict(root=root, forest=sf, X=X, live=live)


def run_stream(ctx: dict, cfg: dict, device: str) -> dict:
    """The stream path (S1, S3, then S2), launch counts zeroed just before
    and read just after, apart from the other paths'.  S1 and S3 score wide
    rows only and S2 narrow rows only, so the frontier counts split by
    width at the boundary.  Returns the counts by kernel row; ``ctx`` keeps
    what the serving path needs (the weights, S3's ms per step, S2's live
    forest with its snapshot and WAL under ``ctx['s2']``)."""
    import torch
    zero_counts()
    stream_datastore(ctx, cfg, device)
    lm_serve_stream(ctx, cfg, device)
    wide = stream_counts()
    keep = {k: ctx[k] for k in ("params", "mcfg", "V", "lm_ms_per_step", "s3_ms_per_step")}
    ctx.clear()
    ctx.update(keep)
    if device == "cuda":
        torch.cuda.empty_cache()
    ctx["s2"] = stream_forest(cfg, device)
    total = stream_counts()
    counts = dict(frontier=total["frontier"] - wide["frontier"],
                  frontier_pruned=total["frontier_pruned"] - wide["frontier_pruned"],
                  frontier_wide=wide["frontier"], frontier_wide_pruned=wide["frontier_pruned"],
                  distance=total["distance"], flash=total["flash"])
    emit("stream_path_launches", **counts)
    if device == "cuda":
        check(wide["frontier_wide"] == wide["frontier"] + wide["frontier_pruned"]
              and total["frontier_wide"] == wide["frontier_wide"],
              "the stream path's frontier launches do not split by width")
        for name in ("frontier", "frontier_pruned", "frontier_wide",
                     "frontier_wide_pruned", "distance"):
            check(counts[name] > 0, f"kernel {name} never launched on the stream path")
    return counts


SERVE_FULL = dict(
    # R1: the index slice's 1,000,000 clustered 20-d d_inf objects,
    # capacity 32, k=10, F=64; the reference's coalescing pair
    # (benchmarks/bench_serve.py: 64 closed-loop clients, width 64 vs 1)
    n=1_000_000, dims=20, capacity=32, clients=64, widths=(64, 1),
    per_client={64: 16, 1: 4}, slo_ms=25.0, pool=4096,
    # the drill's batches: cut from 8 to 4 (with 8 the whole smoke took
    # 621 s on one H100 whose host ran phase 10's decode step at 122 ms)
    drill_batches=4, drill_rows=512, drill_min_per_client=4,
    exact_b=256, exact_fs=(2048, 4096, 8192, 16384),
    # R2: 2 socket-fed replicas under 5% drop and 5% reorder
    replicas=2, fault=dict(seed=7, drop_p=0.05, reorder_p=0.05), chunk_bytes=4096,
    router_b=64,
    write_rows=64,
    # R3: the failover drill, then S2's forest follower at b=1024, F=64
    torn_rows=512, forest_b=1024,
    # R4: launch/serve at full width with the front-end and 2 replicas
    # (--knn-mutate: the reference CI's serving run, so the WAL and the
    # replicas have records to ship)
    serve_argv=["--knn", "--knn-mutate", "--frontend", "--replicas", "2", "--obs"])


class ManualClock:
    """The lease store's clock: expiry is a step the drill takes, not a
    sleep (the failover time below leaves the lease's TTL out)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are a check's, not the path's: every
    launch counter is put back as it was."""
    from repro_torch.kernels.distance import pairwise_distance
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.frontier import frontier_scores
    fields = ((frontier_scores, "launches"), (frontier_scores, "pruned_launches"),
              (frontier_scores, "wide_launches"), (pairwise_distance, "launches"),
              (flash_attention_fwd, "launches"))
    saved = [getattr(o, a) for o, a in fields]
    try:
        yield
    finally:
        for (o, a), v in zip(fields, saved):
            setattr(o, a, v)


def hist_ms(h) -> dict | None:
    """count, mean, p50 (a bucket bound) and max of a seconds histogram, in
    ms; None when it saw nothing."""
    if h.count == 0:
        return None
    return dict(count=h.count, mean=h.mean * 1e3, p50=h.percentile(50) * 1e3,
                max=h.full_snapshot()["max"] * 1e3)


def closed_loop(fe, Q, per_client: int, clients: int, stop=None):
    """``clients`` closed-loop threads, each submitting one query at a time
    and waiting for it (``result()`` re-raises a failed cohort), at least
    ``per_client`` each and on until ``stop`` is set.  Returns (the
    (query, ticket) pairs, wall seconds)."""
    import threading
    start = threading.Barrier(clients + 1)
    errors, done = [], [[] for _ in range(clients)]

    def client(cid):
        try:
            start.wait(60)
            j = 0
            while j < per_client or (stop is not None and not stop.is_set()):
                q = Q[(cid * 7919 + j) % len(Q)]
                tk = fe.submit(q)
                tk.result(600)
                done[cid].append((q, tk))
                j += 1
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    start.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=900)
    dt = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    if errors:
        raise errors[0]
    return [x for d in done for x in d], dt


def recheck_tickets(pins: dict, pairs, F: int, width: int, device: str):
    """Every ticket's row again through ``pinned_knn`` on the epoch its
    ticket names, in rows of ``width``: dists and ids bitwise.  Returns the
    rows checked by epoch."""
    import numpy as np
    import torch

    from repro_torch.serve.frontend import pinned_knn
    by_epoch: dict = {}
    for q, tk in pairs:
        by_epoch.setdefault(tk.epoch, []).append((q, tk))
    with uncounted():
        for e, rows in by_epoch.items():
            check(e in pins, f"a ticket names epoch {e}, which the smoke did not pin")
            for i in range(0, len(rows), width):
                part = rows[i:i + width]
                q = torch.from_numpy(np.stack([r[0] for r in part])).to(device)
                d, ids = pinned_knn(pins[e], q, k=K, max_frontier=F)
                d, ids = d.cpu(), ids.cpu()
                for j, (_, tk) in enumerate(part):
                    check(torch.equal(d[j], tk.dists) and torch.equal(ids[j], tk.ids),
                          f"epoch {e}: a ticket differs from its row re-run on that epoch")
    return {int(e): len(r) for e, r in by_epoch.items()}


def serve_frontend(ctx: dict, cfg: dict, device: str):
    """R1: a ``StreamingEngine`` over the 1M-object d_inf tree (with a WAL
    under a ``FenceGuard``, which R2 ships and R3 fences) behind the
    front-end: 64 closed-loop clients at cohort width 64 and at width 1,
    then the width-64 drill while the scheduler applies ``drill_batches``
    batches of 512 rows (4 at full size, cut from 8), every published
    epoch pinned by the smoke; every ticket re-run
    on its epoch, bitwise; one cohort against the plain scorer; the final
    epoch at the smallest exact F against ``brute_force_knn``."""
    import threading

    import numpy as np
    import torch

    from repro_torch.core import smtree
    from repro_torch.core.distributed import brute_force_knn
    from repro_torch.data.datagen import clustered
    from repro_torch.kernels.frontier import frontier_scores_torch
    from repro_torch.serve.frontend import (FrontendConfig, FrontendStats, ServeFrontend,
                                            pinned_knn)
    from repro_torch.stream import StreamingEngine, WriteAheadLog
    from repro_torch.stream.lease import FenceGuard, LeaseStore

    _, _, wall = timers(device == "cuda")
    n, dim, root = cfg["n"], cfg["dims"], ctx["root"]
    X = clustered(n, dims=dim, seed=0)
    tree0, build_s = wall(lambda: smtree.bulk_build(X, capacity=cfg["capacity"],
                                                    metric="d_inf", device=device))
    clock = ManualClock()
    lease = LeaseStore(f"{root}/lease", ttl_s=5.0, clock=clock)
    grant = lease.try_acquire("leader")
    wal = WriteAheadLog(f"{root}/wal", fence=FenceGuard(lease, "leader", grant.token))
    eng = StreamingEngine(tree0, wal=wal)
    qrng = np.random.default_rng(31)
    rows_ = qrng.integers(0, n, cfg["pool"])
    Q = (X[rows_] + qrng.normal(0, 0.01, (cfg["pool"], dim))).astype(np.float32)
    e0, t0 = eng.epochs.acquire()
    pins = {e0: t0}

    widths = {}
    for width in cfg["widths"]:
        fe = ServeFrontend(eng, FrontendConfig(cohort_width=width, slo_ms=cfg["slo_ms"],
                                               k=K, max_frontier=BENCH_F))
        with fe:
            fe.knn(Q[:width])                   # first cohort of this width
            fe.stats = FrontendStats()
            pairs, dt = closed_loop(fe, Q, cfg["per_client"][width], cfg["clients"])
        s = fe.stats.snapshot()
        checked = recheck_tickets(pins, pairs, BENCH_F, 64, device)
        widths[width] = dict(queries=len(pairs), seconds=dt, qps=len(pairs) / dt,
                             p50_ms=s["p50_ms"], p99_ms=s["p99_ms"],
                             mean_fill=s["mean_cohort_fill"], cohorts=s["n_cohorts"],
                             cohort_ms=hist_ms(fe.stats.cohort_hist), rows_rechecked=checked)
    w_hi, w_lo = cfg["widths"]

    # the drill: the width-64 clients while drill_batches batches of 512 rows apply
    mrng = np.random.default_rng(32)
    gone = mrng.permutation(n)[:cfg["drill_batches"] * cfg["drill_rows"] // 2]
    new_x, batch_s = [], []
    stop, werr = threading.Event(), []
    fe = ServeFrontend(eng, FrontendConfig(cohort_width=w_hi, slo_ms=cfg["slo_ms"],
                                           k=K, max_frontier=BENCH_F))

    def writer():
        try:
            half = cfg["drill_rows"] // 2
            for i in range(cfg["drill_batches"]):
                src = mrng.integers(0, n, half)
                xi = (X[src] + mrng.normal(0, 0.01, (half, dim))).astype(np.float32)
                new_x.append(xi)
                dels = gone[i * half:(i + 1) * half]
                ops = np.concatenate([np.full(half, smtree.OP_INSERT),
                                      np.full(half, smtree.OP_DELETE)]).astype(np.int32)
                xs = np.concatenate([xi, X[dels]])
                oids = np.concatenate([n + i * half + np.arange(half), dels]).astype(np.int32)
                order = mrng.permutation(len(ops))
                t_ = time.perf_counter()
                res = fe.submit_mutations(ops[order], xs[order], oids[order]).result(900)
                batch_s.append(time.perf_counter() - t_)
                check(bool((res.statuses == smtree.ST_APPLIED).all()),
                      f"R1 batch {i}: a row did not apply")
                e, t = eng.epochs.acquire()     # pin every published epoch
                pins[e] = t
        except Exception as exc:  # noqa: BLE001 — re-raised below
            werr.append(exc)
        finally:
            stop.set()

    with fe:
        fe.knn(Q[:w_hi])
        fe.stats = FrontendStats()
        wt = threading.Thread(target=writer, name="r1-writer")
        wt.start()
        pairs, dt = closed_loop(fe, Q, cfg["drill_min_per_client"], cfg["clients"], stop=stop)
        wt.join(timeout=900)
        check(not wt.is_alive(), "R1: the writer hung")
        if werr:
            raise werr[0]
    s = fe.stats.snapshot()
    check(len(pins) == cfg["drill_batches"] + 1, f"R1: {len(pins)} epochs pinned")
    checked = recheck_tickets(pins, pairs, BENCH_F, w_hi, device)
    # one cohort of the last epoch against the plain scorer
    e_last = max(pins)
    with uncounted():
        qp = torch.from_numpy(Q[:w_hi]).to(device)
        dk, ik = pinned_knn(pins[e_last], qp, k=K, max_frontier=BENCH_F)
        dp, ip = pinned_knn(pins[e_last], qp, k=K, max_frontier=BENCH_F,
                            _scorer=frontier_scores_torch)
        check(torch.equal(dk, dp) and torch.equal(ik, ip),
              "R1: the kernel and plain descents differ on a cohort")
    # the final epoch at the smallest exact F against the scan of its live set
    keep = np.ones(n, bool)
    keep[gone] = False
    live_ids = np.concatenate([np.nonzero(keep)[0], n + np.arange(sum(len(x) for x in new_x))])
    Xlive = np.concatenate([X[keep]] + new_x)
    qe = torch.from_numpy(Q[:cfg["exact_b"]]).to(device)
    tried = {}
    with uncounted():
        for Fx in cfg["exact_fs"]:
            tried[Fx] = float(smtree.knn(pins[e_last], qe, k=K, max_frontier=Fx)
                              .overflow.float().mean())
            if tried[Fx] == 0.0:
                break
        check(tried[Fx] == 0.0, "R1: every exact F overflowed")
        de, ie = pinned_knn(pins[e_last], qe, k=K, max_frontier=Fx)
        sd, si = brute_force_knn(torch.from_numpy(Xlive).to(device), qe, k=K + 1,
                                 device=device)
    check(torch.equal(de, sd[:, :K]), "R1 exact: dists differ from the scan")
    distinct = (sd[:, K - 1] != sd[:, K]).cpu()
    want_ids = torch.from_numpy(live_ids)[si[:, :K].cpu()]
    check(torch.equal(torch.sort(ie.cpu()[distinct].long(), 1).values,
                      torch.sort(want_ids[distinct], 1).values),
          "R1 exact: ids differ from the scan")
    for e in pins:
        eng.epochs.release(e)
    hist = fe.stats
    emit("serve_frontend", n=n, dims=dim, capacity=cfg["capacity"], k=K,
         max_frontier=BENCH_F, build_seconds=build_s, clients=cfg["clients"],
         slo_ms=cfg["slo_ms"], widths={str(w): v for w, v in widths.items()},
         coalesce_speedup=widths[w_hi]["qps"] / widths[w_lo]["qps"],
         drill=dict(width=w_hi, batches=cfg["drill_batches"], rows=cfg["drill_rows"],
                    queries=len(pairs), seconds=dt, qps=len(pairs) / dt,
                    p50_ms=s["p50_ms"], p99_ms=s["p99_ms"], mean_fill=s["mean_cohort_fill"],
                    cohorts=s["n_cohorts"], batch_seconds=batch_s,
                    epochs_pinned=len(pins), rows_rechecked_by_epoch=checked,
                    cohorts_behind_apply=s["n_cohorts_behind_apply"],
                    cohort_ms_alone=hist_ms(hist.cohort_hist),
                    cohort_ms_behind_apply=hist_ms(hist.behind_apply_hist)),
         tickets_bitwise_on_their_epochs=True, plain_scorer_cohort_bitwise=True,
         exact=dict(b=cfg["exact_b"], overflow_share_by_F=tried, max_frontier=Fx,
                    rows_ids_checked=int(distinct.sum())))
    ctx.update(eng=eng, tree0=tree0, lease=lease, clock=clock, grant=grant, Q=Q, X=X)


def serve_replication(ctx: dict, cfg: dict, device: str):
    """R2: a ``WalShipServer`` on R1's WAL under seeded 5% drop and 5%
    reorder, and 2 ``ShippedReplica``s on the card caught up through R1's
    batches (``catch_up`` + ``verify``); then a ``ReplicaRouter`` in front:
    leader reads, replica reads under a session floor bitwise equal to the
    leader's at the same seq, and heartbeat-starved degraded reads stamped
    with their staleness."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import smtree
    from repro_torch.serve.frontend import FrontendConfig, ServeFrontend
    from repro_torch.serve.router import ReplicaRouter
    from repro_torch.stream import StreamingEngine, ledger_digest
    from repro_torch.stream.faults import FaultInjector, FaultPlan
    from repro_torch.stream.transport import ShippedReplica, WalShipServer

    eng, tree0, root, Q = ctx["eng"], ctx["tree0"], ctx["root"], ctx["Q"]
    wal = eng.wal
    fault = FaultInjector(FaultPlan(**cfg["fault"]))
    obs.reset()
    obs.enable()
    srv = WalShipServer(wal.directory, wal=wal, fault=fault,
                        chunk_bytes=cfg["chunk_bytes"]).start()
    ctx["srv"] = srv
    reps = [ShippedReplica(StreamingEngine(tree0), srv.address, f"{root}/mirror_{i}",
                           seed=cfg["fault"]["seed"] + i) for i in range(cfg["replicas"])]
    ctx["reps"] = reps
    seq, dg = ledger_digest(eng)
    catch = []
    for rep in reps:
        rep.client.poll()
        rep.replica.note_leader_seq(rep.client.leader_seq)
        lag0 = rep.lag
        t_ = time.perf_counter()
        rep.catch_up(seq, timeout=900)
        rep.verify(seq, dg, timeout=900)
        sec = time.perf_counter() - t_
        catch.append(dict(seconds=sec, records=seq + 1, records_per_s=(seq + 1) / sec,
                          lag_before=lag0, lag_after=rep.lag, rounds=rep.client.n_rounds,
                          rejected_chunks=rep.client.n_rejected_chunks,
                          bytes=dir_bytes(rep.client.mirror_dir), digest_equal=True))
    shipped = obs.counter("transport.bytes_shipped_total").value
    obs.disable()
    check(fault.counts["drop"] + fault.counts["reorder"] > 0, "R2: no fault fired")

    fe = ServeFrontend(eng, FrontendConfig(cohort_width=64, slo_ms=cfg["slo_ms"], k=K,
                                           max_frontier=BENCH_F)).start()
    ctx["fe"] = fe
    router = ReplicaRouter(fe, reps, k=K, max_frontier=BENCH_F)
    ctx["router"] = router
    b = cfg["router_b"]
    qs = Q[:b]
    t_ = time.perf_counter()
    dl, il, tks = router.knn(qs)
    leader_s = time.perf_counter() - t_
    check(all(t.mode == "leader" for t in tks), "R2: a leader read was not the leader's")
    # a write: its session floor sends reads to the leader until the
    # replicas have applied it, then to the replicas
    wrng = np.random.default_rng(33)
    w = cfg["write_rows"]

    def write(start):
        xs = (ctx["X"][wrng.integers(0, cfg["n"], w)] + 0.001).astype(np.float32)
        return router.mutate(np.full(w, smtree.OP_INSERT, np.int32), xs,
                             np.arange(start, start + w, dtype=np.int32))

    _, token = write(2_000_000)
    router.prefer_replicas = True
    tk = router.query(qs[0], session=token)
    tk.result(60)
    check(tk.mode == "leader", "R2: a read under an unmet floor did not go to the leader")
    for rep in reps:
        rep.catch_up(token.wal_seq, timeout=600)
    t_ = time.perf_counter()
    dr, ir, tkr = router.knn(qs, session=token)
    replica_s = time.perf_counter() - t_
    check(all(t.mode == "replica" for t in tkr), "R2: a floor-satisfying read was not a replica's")
    router.prefer_replicas = False
    dl2, il2, tkl = router.knn(qs)
    check(all(t.mode == "leader" for t in tkl), "R2: leader reads")
    check(torch.equal(dr, dl2) and torch.equal(ir, il2),
          "R2: replica reads differ from leader reads at the same seq")
    # degraded: the replicas hold the next write but have not replayed it
    _, token2 = write(2_100_000)
    for rep in reps:
        for _ in range(50):
            rep.client.poll()
            rep.replica.note_leader_seq(rep.client.leader_seq)
            if rep.client.leader_seq >= token2.wal_seq:
                break
    router.fault = FaultInjector(FaultPlan(heartbeat_drop_p=1.0))
    for _ in range(router.miss_limit):
        router.heartbeat()
    check(not router.leader_up, "R2: starved heartbeats left the leader up")
    t_ = time.perf_counter()
    dd, idd, tkd = router.knn(qs)
    degraded_s = time.perf_counter() - t_
    check(all(t.mode == "degraded" for t in tkd), "R2: a leaderless read was not degraded")
    stal = sorted({t.staleness for t in tkd})
    check(stal == [1], f"R2: degraded reads stamped {stal}, not one record behind")
    router.fault = None
    check(router.heartbeat(), "R2: one healthy heartbeat did not restore the leader")
    for rep in reps:
        rep.catch_up(token2.wal_seq, timeout=600)
    emit("serve_replication", replicas=len(reps), fault=cfg["fault"],
         fault_counts=dict(fault.counts), wal_records=seq + 1,
         bytes_shipped=shipped, catch_up=catch,
         router=dict(b=b, leader_ms_per_read=leader_s * 1e3 / b,
                     replica_ms_per_read=replica_s * 1e3 / b,
                     degraded_ms_per_read=degraded_s * 1e3 / b,
                     replica_reads_bitwise_to_leader=True, floor_seq=token.wal_seq,
                     degraded_staleness=stal, snapshot=router.snapshot()))


def serve_failover(ctx: dict, cfg: dict, device: str):
    """R3: the chaos drill at full size — the leader, under its
    ``FenceGuard``, is killed mid-batch (a torn half-frame); reads go on
    degraded, writes raise ``LeaderUnavailable``; replica 0 is promoted
    under a higher token to the last acknowledged (seq, digest); the
    deposed leader's append raises ``FencedOut``; writes flow again after
    ``set_leader``; failover ms from the kill to the first read.  Then
    ``promote_follower`` on a forest follower restored from S2's snapshot
    and WAL, its forest kNN bitwise to the live forest's."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import distributed as fd
    from repro_torch.core import smtree
    from repro_torch.serve.frontend import FrontendConfig, ServeFrontend
    from repro_torch.serve.router import LeaderUnavailable
    from repro_torch.stream import (FencedOut, Replica, WriteAheadLog, iter_wal,
                                    ledger_digest)
    from repro_torch.stream.lease import FenceGuard, promote
    from repro_torch.stream.wal import KIND_BATCH, WalRecord, _encode, _scan_dir

    _, _, wall = timers(device == "cuda")
    eng, router, reps, Q = ctx["eng"], ctx["router"], ctx["reps"], ctx["Q"]
    lease, clock, grant = ctx["lease"], ctx["clock"], ctx["grant"]
    wal = eng.wal
    seq, dg = ledger_digest(eng)              # the last acknowledged state
    rng = np.random.default_rng(34)
    t = cfg["torn_rows"]
    frame = _encode(WalRecord(KIND_BATCH, seq + 1, ops=np.full(t, smtree.OP_INSERT, np.int8),
                              oids=np.arange(3_000_000, 3_000_000 + t, dtype=np.int32),
                              xs=rng.random((t, cfg["dims"])).astype(np.float32)))
    cut = int(rng.integers(1, len(frame) - 1))
    t_kill = time.perf_counter()
    wal.close()
    with open(os.path.join(wal.directory, _scan_dir(wal.directory)[-1]), "ab") as f:
        f.write(frame[:cut])
    ctx.pop("fe").stop()                      # the leader process is gone
    router.mark_leader_down()
    tk = router.query(Q[0])
    tk.result(60)
    check(tk.mode == "degraded", "R3: a leaderless read was not degraded")
    try:
        router.mutate(np.full(1, smtree.OP_INSERT, np.int32), Q[:1], np.array([7], np.int32))
        check(False, "R3: a write went through with no leader")
    except LeaderUnavailable:
        pass
    clock.t += 6.0                            # the dead leader's lease lapses
    t_promo = time.perf_counter()
    promo = promote(reps[0], lease, "replica-0", target=(seq, dg), drain_timeout=900)
    promo_s = time.perf_counter() - t_promo
    ctx["promo_wal"] = promo.wal
    check(promo.lease.token > grant.token, "R3: the promotion did not raise the token")
    check(promo.applied_seq == seq and promo.digest == dg,
          "R3: the promoted replica is not at the last acknowledged state")
    check(seq + 1 not in {r.seq for r in iter_wal(reps[0].client.mirror_dir)},
          "R3: the torn batch reached the promoted log")
    fe2 = ServeFrontend(reps[0].follower, FrontendConfig(cohort_width=64, slo_ms=cfg["slo_ms"],
                                                         k=K, max_frontier=BENCH_F)).start()
    ctx["fe"] = fe2
    router.replicas = reps[1:]
    router.set_leader(fe2)
    tk = router.query(Q[1])
    tk.result(60)
    failover_ms = (time.perf_counter() - t_kill) * 1e3
    check(tk.mode == "leader", "R3: the first read after promotion was not the leader's")
    zombie = WriteAheadLog(wal.directory, fence=FenceGuard(lease, "leader", grant.token))
    try:
        zombie.append_batch(np.full(1, smtree.OP_INSERT, np.int8), Q[:1],
                            np.array([7], np.int32))
        check(False, "R3: the deposed leader appended")
    except FencedOut:
        pass
    finally:
        zombie.close()
    _, token = router.mutate(np.full(4, smtree.OP_INSERT, np.int32), Q[:4] + 0.002,
                             np.arange(3_100_000, 3_100_004, dtype=np.int32))
    check(token.wal_seq == seq + 1, f"R3: the new leader's first write took seq {token.wal_seq}")
    tk = router.query(Q[2], session=token)
    tk.result(60)
    check(tk.mode == "leader", "R3: a read after the write")

    # promote_follower: a forest follower from S2's snapshot and WAL
    s2 = ctx["s2"]
    sf = s2["forest"]
    qrng = np.random.default_rng(35)
    live = s2["live"]
    rows_ = live[qrng.integers(0, len(live), cfg["forest_b"])]
    Xs = s2["X"]
    Qf = torch.from_numpy((Xs[rows_] + qrng.normal(0, 0.01, (cfg["forest_b"], Xs.shape[1])))
                          .astype(np.float32)).to(device)
    expect = ledger_digest(sf)
    rep, restore_s = wall(lambda: Replica.from_snapshot(f"{s2['root']}/ck",
                                                        f"{s2['root']}/wal", device=device))
    (placed, epoch), promote_s = wall(lambda: fd.promote_follower(
        rep, device=device, expect=expect, timeout=900))
    d, i = fd.forest_knn(placed, Qf, k=K, max_frontier=BENCH_F)
    with uncounted(), sf.epochs.reading() as pinned:
        dl, il = fd.forest_knn(fd.stack_trees(list(pinned)), Qf, k=K, max_frontier=BENCH_F)
    check(torch.equal(d, dl) and torch.equal(i, il),
          "R3: the promoted forest's kNN differs from the live forest's")
    emit("serve_failover", seq=seq, torn_cut=cut, torn_frame_bytes=len(frame),
         token_before=grant.token, token_after=promo.lease.token,
         promote_seconds=promo_s, failover_ms=failover_ms,
         failover_excludes="the lease's TTL (the store's clock is stepped past it)",
         digest_equal=True, fenced_out=True, writes_after_promotion_seq=token.wal_seq,
         forest=dict(n_shards=int(placed.root.shape[0]), restore_seconds=restore_s,
                     promote_follower_seconds=promote_s, epoch=epoch, seq=expect[0],
                     b=cfg["forest_b"], max_frontier=BENCH_F, knn_bitwise_to_live=True))


def lm_serve_frontend(ctx: dict, cfg: dict, device: str):
    """R4: ``launch/serve --knn --knn-mutate --frontend --replicas 2 --obs``
    on phase 10's weights at full width: ms per decode step beside phase
    10's and S3's, the front-end's counters, the replicas' max lag; the
    ``[obs]`` snapshot covers the frontend, router, replica, wal and
    descent rows, and ``fetch_metrics`` over the ship socket returns the
    same families."""
    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.obs.export import fetch_metrics, metrics_snapshot, missing_rows

    params, mcfg, V = ctx["params"], ctx["mcfg"], ctx["V"]
    argv = cfg["serve_argv"]
    args = serve.parser().parse_args(argv + ["--device", device])
    obs.reset()
    obs.enable()
    store = None
    try:
        store = serve._build_store(args, mcfg, device)
        toks, timing = serve.serve_loop(args, mcfg, params, store)
        store.frontend.drain()
        for rep in store.replicas:             # the replicas' rows, then the wire
            rep.catch_up(store.stream.wal.next_seq - 1, timeout=600)
        fetched = fetch_metrics(store.ship_server.address)
        fe = serve._finish_frontend(store, args)
        snap = metrics_snapshot()
    finally:
        if store is not None and store.frontend is not None:
            store.close_replication()
            store.close_frontend()
        obs.disable()
        obs.reset()
    check(toks.shape == (args.batch, args.steps + 1)
          and bool(((toks >= 0) & (toks < V)).all()), "R4: bad tokens")
    families = ["frontend.", "router.", "replica.", "wal.", "descent."]
    check(missing_rows(snap, families) == [], f"R4: missing {missing_rows(snap, families)}")
    check(missing_rows(fetched, families) == [],
          f"R4: fetch_metrics missing {missing_rows(fetched, families)}")
    fam = lambda s: sorted({k.split(".")[0] for k in s["metrics"]})  # noqa: E731
    check(set(fam(fetched)) <= set(fam(snap)), "R4: fetch_metrics returned other families")
    r = fe["router"]
    check(fe["frontend"]["n_queries"] == args.batch * args.steps, "R4: front-end queries")
    check(r["max_replica_lag"] == 0, f"R4: replicas ended {r['max_replica_lag']} behind")
    emit("lm_serve_frontend", arch=mcfg.name, argv=argv,
         ms_per_decode_step=timing["ms_per_step"],
         lm_serve_ms_per_decode_step=ctx["lm_ms_per_step"],
         stream_ms_per_decode_step=ctx.get("s3_ms_per_step"),
         mutations=timing["mutations"], frontend=fe["frontend"],
         replicas=dict(n=len(r["replica_lags"]), lags=r["replica_lags"],
                       max_lag=r["max_replica_lag"], wal_seq=fe["wal_seq"]),
         obs_families=fam(snap), fetch_metrics_families=fam(fetched),
         missing_rows=[])


def run_serve(ctx: dict, cfg: dict, device: str) -> dict:
    """The serving path (R1-R4), launch counts zeroed just before and read
    just after, apart from the other paths'.  R1-R3 score narrow rows only
    and R4 wide rows only, so the frontier counts split by width at the
    boundary.  The checks' launches (the ticket re-runs, the plain-scorer
    cohort, R1's exact-F search and scan, R3's live-forest reference) are
    put back by ``uncounted()``, so the distance scan, which only a check
    runs here, counts 0.  Returns the counts by kernel row."""
    import shutil
    import tempfile

    import torch
    ctx["root"] = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    seconds = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        fn(ctx, cfg, device)
        seconds[name] = time.perf_counter() - t0

    try:
        zero_counts()
        phase("R1", serve_frontend)
        phase("R2", serve_replication)
        phase("R3", serve_failover)
        narrow = stream_counts()
        _close_serve(ctx)
        if device == "cuda":
            torch.cuda.empty_cache()
        phase("R4", lm_serve_frontend)
        total = stream_counts()
    finally:
        _close_serve(ctx)
        shutil.rmtree(ctx.pop("root"), ignore_errors=True)
        shutil.rmtree(ctx.pop("s2")["root"], ignore_errors=True)
    counts = dict(frontier=narrow["frontier"], frontier_pruned=narrow["frontier_pruned"],
                  frontier_wide=total["frontier"] - narrow["frontier"],
                  frontier_wide_pruned=total["frontier_pruned"] - narrow["frontier_pruned"],
                  distance=total["distance"], flash=total["flash"])
    emit("serve_path_launches", **counts, seconds=seconds)
    if device == "cuda":
        check(narrow["frontier_wide"] == 0
              and total["frontier_wide"] == counts["frontier_wide"]
              + counts["frontier_wide_pruned"],
              "the serve path's frontier launches do not split by width")
        for name in ("frontier", "frontier_pruned", "frontier_wide", "frontier_wide_pruned"):
            check(counts[name] > 0, f"kernel {name} never launched on the serve path")
    return counts


def _close_serve(ctx: dict) -> None:
    """Stop every thread and socket of R1-R3 and drop their state."""
    for key in ("fe", "router"):
        obj = ctx.pop(key, None)
        if obj is not None:
            obj.stop()
    for rep in ctx.pop("reps", []):
        rep.stop()
    srv = ctx.pop("srv", None)
    if srv is not None:
        srv.stop()
    wal = ctx.pop("promo_wal", None)
    if wal is not None:
        wal.close()
    for key in ("eng", "tree0", "lease", "clock", "grant", "Q", "X"):
        ctx.pop(key, None)
    if "s2" in ctx:
        ctx["s2"].pop("forest", None)


def routing_agreement(r1: list, r2: list, shape) -> tuple:
    """Two runs' MoE routing (``_routing`` records, one per MoE layer): the
    share of (layer, token, choice) routings whose expert differs, and the
    tokens [*shape] whose choices and kept slots agreed in every layer
    (every token where the model has no MoE layer)."""
    import torch
    if not r1 and not r2:
        return 0.0, torch.ones(shape, dtype=torch.bool)
    differ = total = 0
    agree = None
    for a, b in zip(r1, r2, strict=True):
        d = a["gate_i"] != b["gate_i"]
        differ += int(d.sum())
        total += d.numel()
        same = ~(d | (a["keep"] != b["keep"])).any(-1)
        agree = same if agree is None else agree & same
    return differ / total, agree.reshape(shape)


def logits_against_plain(kernel_host, plain, agree) -> dict:
    """The kernel run's logits (kept on the host: one [b, s, V] tensor on
    the card at a time) against the plain run's, batch row by batch row,
    over the tokens whose routing agreed ([b, s]): max |err|, max |plain
    logit|, and whether the last position's argmax is the same in every
    row whose last token agreed."""
    err, top, argmax_eq, rows = 0.0, 0.0, True, 0
    for i in range(plain.shape[0]):
        k_i = kernel_host[i].to(plain.device)
        top = max(top, float(plain[i].abs().max()))
        ok = agree[i].to(plain.device)
        if bool(ok.any()):
            err = max(err, float((k_i - plain[i]).abs()[ok].max()))
        if bool(ok[-1]):
            rows += 1
            argmax_eq &= bool(k_i[-1].argmax() == plain[i][-1].argmax())
        del k_i
    return dict(max_abs_logit_err=err, max_abs_logit=top, last_argmax_equal=argmax_eq,
                last_argmax_rows=rows, tokens_compared=int(agree.sum()))


def serve_family(phase: str, fcfg: dict, mcfg, params, device: str) -> tuple:
    """``launch/serve`` with ``fcfg["serve_argv"]`` on these weights (a
    2048-key store of width d_model), then the served store's retrieval at
    the served batch held bitwise against the plain-scorer descent (a
    check, outside the counts).  Returns (its record, the loop's launch
    counts, its decode steps)."""
    import torch

    from repro_torch.kernels.frontier import frontier_scores_torch
    from repro_torch.launch import serve

    on_card = device == "cuda"
    _, _, wall = timers(on_card)
    args = serve.parser().parse_args(fcfg["serve_argv"] + ["--device", device])
    store, store_s = wall(lambda: serve._build_store(args, mcfg, device))
    c0 = stream_counts()
    toks, timing = serve.serve_loop(args, mcfg, params, store)
    sc = {k: v - c0[k] for k, v in stream_counts().items()}
    check(toks.shape == (args.batch, args.steps + 1)
          and bool(((toks >= 0) & (toks < mcfg.padded_vocab)).all()),
          f"{phase}: serve: bad tokens")
    # the served store's retrieval (keys d_model wide: 4096 for jamba) at
    # the served batch, against the plain-scorer descent, bitwise: a check,
    # outside the counts
    q = params.embed[torch.as_tensor(toks[:, -1]).to(params.embed.device).long()].float()
    with uncounted():
        c1 = stream_counts()
        res = store.retrieve(q)
        ret_launches = {k: v - c1[k] for k, v in stream_counts().items()}
        ref = store.retrieve(q, _scorer=frontier_scores_torch)
    for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"{phase}: serve store b={args.batch}: kernel and plain descents differ in {f}")
    if on_card:
        check(ret_launches["frontier_wide"] > 0
              and ret_launches["frontier_wide"] == ret_launches["frontier"]
              + ret_launches["frontier_pruned"],
              f"{phase}: the retrieval check did not run the wide kernel alone")
    rec = dict(argv=fcfg["serve_argv"], batch=args.batch, prompt_len=args.prompt_len,
               steps=args.steps, store_keys=len(store.values), key_width=mcfg.d_model,
               store_build_seconds=store_s,
               prompt_feed_ms_per_token=timing["prefill_s"] * 1e3 / args.prompt_len,
               ms_per_decode_step=timing["ms_per_step"],
               wide_launches_per_step=sc["frontier_wide"] / args.steps,
               retrieval_bitwise_vs_plain=dict(b=args.batch, launches=ret_launches),
               launches=sc, sample=toks[0][:12].tolist())
    if on_card:
        with uncounted():
            rec["profile_decode_step_knn"] = profile_decode_knn(
                params, mcfg, store, toks[:, 0], args.lam)
    return rec, sc, args.steps


def lm_family(phase: str, fcfg: dict, device: str, max_flip_share: float,
              reps: int) -> dict:
    """One decoder block family at full width (``lm_moe``, ``lm_hybrid``,
    ``lm_xlstm``), launch counts zeroed just before and read just after:
    seeded random weights, the exact parameter count, a prefill at b x s
    through ``make_prefill_step`` (the flash kernel once per attention
    layer, none for xLSTM), held against the same prefill through the
    plain attention on the tokens whose routing agreed in every MoE layer
    (the share of routings that differ reported and bounded), where its
    device time goes, with ``decode_len`` a decode held against a forward
    made dropless like it, then ``launch/serve`` with ``--knn`` on these
    weights.  Returns the path's counts by kernel row and its launches per
    pass."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_prefill_step

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, _, wall = timers(on_card)
    free = (lambda: torch.cuda.empty_cache()) if on_card else (lambda: None)
    base = smoke_config(fcfg["arch"]) if fcfg["smoke"] else get_config(fcfg["arch"])
    mcfg = dataclasses.replace(base, **fcfg["overrides"])
    n_attn = sum(k.startswith("attn") for k in mcfg.block_pattern) * mcfg.n_periods
    n_moe = sum(k.endswith("_moe") for k in mcfg.block_pattern) * mcfg.n_periods
    reduced = ([f"depth: {mcfg.n_layers} of {base.n_layers} layers (one period of "
                f"{len(base.block_pattern)}): all {base.n_layers} hold over "
                f"{base.param_count * 4 / 1e9:.0f} GB in f32, more than the card's 80 GB"]
               if mcfg.n_layers < base.n_layers else [])

    zero_counts()
    resident_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    params, init_s = wall(lambda: M.init_params(mcfg, 0, device=device))
    n_params = M.param_count(params)
    check(n_params == fcfg["params"], f"{phase}: {n_params} parameters, not {fcfg['params']}")
    weights_gb = None
    if on_card:
        weights_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    B, S, V = fcfg["prefill_b"], fcfg["prefill_s"], mcfg.padded_vocab
    tokens = torch.from_numpy(synth_batch(DataConfig(
        vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B), 0,
        with_labels=False)["tokens"]).to(dev)
    batch = {"tokens": tokens}
    # the first prefill through ``forward`` (what ``make_prefill_step``
    # wraps), for its aux; the timed ones through ``make_prefill_step``
    rk = []
    c0 = stream_counts()["flash"]
    (logits, aux), prefill_s = wall(lambda: M.forward(params, mcfg, batch, _routing=rk))
    per_forward = stream_counts()["flash"] - c0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    if on_card:
        check(per_forward == n_attn,
              f"{phase}: {per_forward} flash launches in one forward, not {n_attn}")
    check(len(rk) == n_moe, f"{phase}: {len(rk)} routing records, not {n_moe}")
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V),
          f"{phase}: prefill logits: shape or non-finite values")
    aux = {k: float(v) for k, v in aux.items()}
    kernel_host = logits.cpu()
    del logits
    prefill = make_prefill_step(mcfg)
    again = [wall(lambda: prefill(params, batch))[1] for _ in range(reps)]

    # the same prefill through the plain attention: the routing may flip at
    # near ties, so the logits are held on the tokens whose routing agreed
    rp = []
    with uncounted():
        plain, plain_s = wall(lambda: make_prefill_step(
            mcfg, _attention=flash_attention_torch, _routing=rp)(params, batch))
    flip_share, agree = routing_agreement(rk, rp, (B, S))
    check(flip_share <= max_flip_share,
          f"{phase}: {flip_share:.2e} of the routings differ from the plain run's")
    cmp = logits_against_plain(kernel_host, plain, agree)
    check(cmp["tokens_compared"] > 0, f"{phase}: no token's routing agreed")
    check(cmp["max_abs_logit_err"] <= 1e-3 * cmp["max_abs_logit"],
          f"{phase}: prefill logits kernel vs plain {cmp['max_abs_logit_err']} > 1e-3 x "
          f"{cmp['max_abs_logit']}")
    check(cmp["last_argmax_equal"], f"{phase}: last-position argmax differs from the plain path")
    del plain, kernel_host, rk, rp
    free()

    # where the prefill's time goes, by kernel and by layer kind
    with uncounted():
        where, profile_s = wall(lambda: profile_device(lambda: prefill(params, batch),
                                                       float(np.median(again)) * 1e3, on_card))
    where["seconds"] = profile_s

    out = dict(arch=mcfg.name, n_layers=mcfg.n_layers, d_model=mcfg.d_model,
               pattern=list(mcfg.block_pattern), experts=[mcfg.n_experts,
                                                          mcfg.experts_per_token,
                                                          mcfg.n_shared_experts],
               heads=[mcfg.n_heads, mcfg.n_kv_heads], vocab=mcfg.vocab_size,
               dtype=mcfg.param_dtype, params=n_params, cfg_param_count=mcfg.param_count,
               reduced=reduced, resident_before_gb=resident_gb, init_seconds=init_s,
               weights_gb=weights_gb,
               prefill=dict(b=B, s=S, ms=[prefill_s * 1e3] + [t * 1e3 for t in again],
                            plain_attention_ms=plain_s * 1e3, peak_gb=peak_gb,
                            flash_launches_per_forward=per_forward, moe_layers=n_moe,
                            aux=aux, routing_differs_share=flip_share, **cmp,
                            profile=where))

    if fcfg.get("decode_len"):
        # decode against a forward made dropless like it (capacity factor
        # E / k; without MoE layers the forward itself): a check, outside
        # the counts
        dcfg = (dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts / mcfg.experts_per_token)
                if mcfg.n_experts else mcfg)
        Bd, Ld = fcfg["decode_b"], fcfg["decode_len"]
        dtoks = tokens[:Bd, :Ld]
        with uncounted():
            rf = []
            full, faux = M.forward(params, dcfg, {"tokens": dtoks}, _routing=rf)
            check(float(faux["drop_frac"]) == 0.0, f"{phase}: the dropless forward dropped")
            cache = M.init_cache(dcfg, Bd, Ld, device=device)
            rd = [[] for _ in rf]
            sync()
            t0 = time.perf_counter()
            steps = []
            for pos in range(Ld):
                rs = []
                lg, cache = M.decode_step(params, dcfg, dtoks[:, pos], cache, pos, _routing=rs)
                for acc, r in zip(rd, rs, strict=True):
                    acc.append(r)
                steps.append(lg)
            sync()
            dec_s = time.perf_counter() - t0
        # the decode's records stacked to the forward's [b * s, k] layout
        stacked = [dict(gate_i=torch.stack([r["gate_i"] for r in acc], 1).reshape(Bd * Ld, -1),
                        keep=torch.stack([r["keep"] for r in acc], 1).reshape(Bd * Ld, -1))
                   for acc in rd]
        d_flip, d_agree = routing_agreement(rf, stacked, (Bd, Ld))
        dec = torch.stack(steps, 1)
        top = float(full.abs().max())
        check(bool(d_agree.any()), f"{phase}: no decoded token's routing agreed")
        derr = float((dec - full).abs().amax(-1)[d_agree.to(full.device)].max())
        check(d_flip <= max_flip_share, f"{phase}: decode routing differs in {d_flip:.2e}")
        check(derr <= 1e-3 * top, f"{phase}: decode vs dropless forward {derr} > 1e-3 x {top}")
        out["decode_vs_forward"] = dict(b=Bd, tokens=Ld, capacity_factor=(
                                            dcfg.capacity_factor if mcfg.n_experts else None),
                                        max_abs_logit_err=derr, max_abs_logit=top,
                                        routing_differs_share=d_flip,
                                        tokens_compared=int(d_agree.sum()),
                                        ms_per_step=dec_s * 1e3 / Ld)
        del full, dec, steps, cache, rf, rd, stacked
        free()

    out["serve"], sc, steps = serve_family(phase, fcfg, mcfg, params, device)
    del params, tokens
    free()

    c = stream_counts()
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=c["frontier"],
                  frontier_wide_pruned=c["frontier_pruned"], distance=c["distance"],
                  flash=c["flash"])
    out["launches"] = counts
    emit(phase, **out)
    if on_card:
        check(c["frontier_wide"] == c["frontier"] + c["frontier_pruned"],
              f"{phase}: a narrow frontier launch on an LM path")
        # xLSTM has no attention layer: its path launches no flash kernel
        check(n_attn or counts["flash"] == 0, f"{phase}: a flash launch with no attention layer")
        for name in (("flash",) if n_attn else ()) + ("frontier_wide", "frontier_wide_pruned"):
            check(counts[name] > 0, f"kernel {name} never launched on the {phase} path")
    return dict(counts=counts, per_pass=dict(
        prefill_forward=per_forward,
        decode_step_knn=sc["frontier"] / steps,
        decode_step_knn_pruned=sc["frontier_pruned"] / steps))


def lm_audio(phase: str, fcfg: dict, device: str, reps: int) -> dict:
    """whisper-tiny at full size (``lm_audio``), launch counts zeroed just
    before and read just after: seeded random weights, the exact parameter
    count, seeded frames [b, 1500, 384] (the conv stub's output for a 30-s
    window) and decoder tokens [b, 448]; a forward through
    ``make_prefill_step`` (the flash kernel once per encoder layer, and
    twice per decoder layer: causal self-attention, cross-attention onto
    the frames) held against the same forward through the plain attention;
    where its device time goes; ``encdec_prefill_cache`` (the encoder's
    launches) and a cached decode of the first ``decode_len`` tokens held
    against the forward's logits; then ``launch/serve --arch whisper-tiny
    --knn``.  Returns the path's counts by kernel row and its launches per
    pass."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_prefill_step

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, _, wall = timers(on_card)
    free = (lambda: torch.cuda.empty_cache()) if on_card else (lambda: None)
    mcfg = smoke_config(fcfg["arch"]) if fcfg["smoke"] else get_config(fcfg["arch"])
    n_enc, n_dec = mcfg.encoder_layers, mcfg.n_layers

    zero_counts()
    params, init_s = wall(lambda: M.init_params(mcfg, 0, device=device))
    n_params = M.param_count(params)
    check(n_params == fcfg["params"], f"{phase}: {n_params} parameters, not {fcfg['params']}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    B, S_enc, S, V = fcfg["prefill_b"], fcfg["frames"], fcfg["prefill_s"], mcfg.padded_vocab
    gen = torch.Generator(device=dev).manual_seed(11)
    frames = torch.randn((B, S_enc, mcfg.d_model), generator=gen, device=dev)
    tokens = torch.from_numpy(synth_batch(DataConfig(
        vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B), 0,
        with_labels=False)["tokens"]).to(dev)
    batch = {"frames": frames, "tokens": tokens}

    prefill = make_prefill_step(mcfg)
    c0 = stream_counts()["flash"]
    logits, prefill_s = wall(lambda: prefill(params, batch))
    per_forward = stream_counts()["flash"] - c0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    if on_card:
        check(per_forward == n_enc + 2 * n_dec,
              f"{phase}: {per_forward} flash launches in one forward, not {n_enc + 2 * n_dec}")
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V),
          f"{phase}: forward logits: shape or non-finite values")
    again = [wall(lambda: prefill(params, batch))[1] for _ in range(reps)]
    with uncounted():
        plain, plain_s = wall(lambda: make_prefill_step(
            mcfg, _attention=flash_attention_torch)(params, batch))
    err = float((logits - plain).abs().max())
    top = float(plain.abs().max())
    check(err <= 1e-3 * top, f"{phase}: forward logits kernel vs plain {err} > 1e-3 x {top}")
    argmax_eq = torch.equal(logits[:, -1].argmax(-1), plain[:, -1].argmax(-1))
    check(argmax_eq, f"{phase}: last-position argmax differs from the plain path")
    del plain
    free()
    with uncounted():
        where, profile_s = wall(lambda: profile_device(lambda: prefill(params, batch),
                                                       float(np.median(again)) * 1e3, on_card))
    where["seconds"] = profile_s

    # the encoder once, filling every decoder layer's cross K/V, then the
    # cached decode of the first decode_len tokens against the forward
    Ld = fcfg["decode_len"]
    c0 = stream_counts()["flash"]
    cache, cache_s = wall(lambda: encdec.encdec_prefill_cache(
        params, mcfg, frames, M.init_cache(mcfg, B, S_enc, device=device)))
    per_cache = stream_counts()["flash"] - c0
    if on_card:
        check(per_cache == n_enc,
              f"{phase}: {per_cache} flash launches in encdec_prefill_cache, not {n_enc}")
    sync()
    t0 = time.perf_counter()
    steps = []
    for pos in range(Ld):
        lg, cache = M.decode_step(params, mcfg, tokens[:, pos], cache, pos)
        steps.append(lg)
    sync()
    dec_s = time.perf_counter() - t0
    full = logits[:, :Ld]
    dtop = float(full.abs().max())
    derr = float((torch.stack(steps, 1) - full).abs().max())
    check(derr <= 1e-3 * dtop, f"{phase}: cached decode vs forward {derr} > 1e-3 x {dtop}")
    del logits, full, steps, cache
    free()

    out = dict(arch=mcfg.name, enc_layers=n_enc, dec_layers=n_dec, d_model=mcfg.d_model,
               heads=[mcfg.n_heads, mcfg.d_head], vocab=mcfg.vocab_size,
               dtype=mcfg.param_dtype, params=n_params, cfg_param_count=mcfg.param_count,
               reduced=[], init_seconds=init_s,
               forward=dict(b=B, frames=S_enc, tokens=S,
                            ms=[prefill_s * 1e3] + [t * 1e3 for t in again],
                            plain_attention_ms=plain_s * 1e3, peak_gb=peak_gb,
                            flash_launches_per_forward=per_forward, max_abs_logit_err=err,
                            max_abs_logit=top, last_argmax_equal=argmax_eq, profile=where),
               prefill_cache=dict(ms=cache_s * 1e3, flash_launches=per_cache),
               decode_vs_forward=dict(b=B, tokens=Ld, max_abs_logit_err=derr,
                                      max_abs_logit=dtop, ms_per_step=dec_s * 1e3 / Ld))
    out["serve"], sc, n_steps = serve_family(phase, fcfg, mcfg, params, device)
    del params, tokens, frames, batch
    free()

    c = stream_counts()
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=c["frontier"],
                  frontier_wide_pruned=c["frontier_pruned"], distance=c["distance"],
                  flash=c["flash"])
    out["launches"] = counts
    emit(phase, **out)
    if on_card:
        check(c["frontier_wide"] == c["frontier"] + c["frontier_pruned"],
              f"{phase}: a narrow frontier launch on an LM path")
        for name in ("flash", "frontier_wide", "frontier_wide_pruned"):
            check(counts[name] > 0, f"kernel {name} never launched on the {phase} path")
    return dict(counts=counts, per_pass=dict(
        prefill_forward=per_forward, prefill_cache=per_cache,
        decode_step_knn=sc["frontier"] / n_steps,
        decode_step_knn_pruned=sc["frontier_pruned"] / n_steps))


def run_lm_families(cfg: dict, device: str) -> dict:
    """The block families, each phase's launches apart: ``lm_moe``
    (qwen2-moe-a2.7b), ``lm_hybrid`` (jamba-v0.1-52b, one period),
    ``lm_xlstm`` (xlstm-1.3b) and ``lm_audio`` (whisper-tiny); each
    phase's weights go before the next one's are drawn.  Returns {phase:
    its counts and launches per pass}."""
    out = {}
    for phase, key in (("lm_moe", "moe"), ("lm_hybrid", "hybrid"), ("lm_xlstm", "xlstm"),
                       ("lm_audio", "audio")):
        t0 = time.perf_counter()
        if key == "audio":
            out[phase] = lm_audio(phase, cfg[key], device, cfg["timing_reps"])
        else:
            out[phase] = lm_family(phase, cfg[key], device, cfg["max_flip_share"],
                                   cfg["timing_reps"])
        out[phase]["seconds"] = time.perf_counter() - t0
        gc.collect()
    emit("lm_families_launches", **{k: dict(v["counts"], seconds=v["seconds"])
                                     for k, v in out.items()})
    return out


def profile_train(fn, wall_ms: float, on_card: bool = True) -> dict:
    """One training step by phase (torch.profiler).  The step opens
    ``train.forward``, ``train.backward`` and ``train.optimizer`` ranges and
    waits for the card at the end of each (``train_step._phase``), so every
    kernel of a phase starts inside that phase's host-side range.  Per
    phase: its host span, the busy ms and count of the kernels that start
    in it, and the calls and device-side spans of the ``block.<kind>``
    ranges that start in it (the backward's are remat's recompute); the
    step's busy ms, its idle share of ``wall_ms`` and the top 8 kernels.
    Off the card, only the phases' spans and the blocks' calls."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if on_card:
            torch.cuda.synchronize()
    phases, kernels, blocks = {}, [], []
    for ev in prof.profiler.kineto_results.events():
        name, dev = ev.name(), "cuda" if "CUDA" in str(ev.device_type()) else "cpu"
        if name.startswith("train.") and dev == "cpu":
            phases[name.removeprefix("train.")] = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        elif name.startswith("block."):
            if (dev == "cuda") == on_card:
                blocks.append((name.removeprefix("block."), ev.start_ns(), ev.duration_ns()))
        elif dev == "cuda" and not ev.is_user_annotation():
            kernels.append((name, ev.start_ns(), ev.duration_ns()))

    def phase_of(t):
        return next((k for k, (a, b) in phases.items() if a <= t <= b), "outside")

    by_phase = {k: dict(span_ms=(b - a) / 1e6, busy_ms=0.0 if on_card else None, kernels=0,
                        blocks={}) for k, (a, b) in phases.items()}
    by_phase["outside"] = dict(span_ms=None, busy_ms=0.0 if on_card else None, kernels=0,
                               blocks={})
    top: dict = {}
    for name, t, dur in kernels:
        ph = by_phase[phase_of(t)]
        ph["busy_ms"] += dur / 1e6
        ph["kernels"] += 1
        k = top.setdefault(name, [0.0, 0])
        k[0] += dur / 1e6
        k[1] += 1
    for kind, t, dur in blocks:
        b = by_phase[phase_of(t)]["blocks"].setdefault(
            kind, dict(calls=0, span_ms=0.0 if on_card else None))
        b["calls"] += 1
        if on_card:
            b["span_ms"] += dur / 1e6
    if not by_phase["outside"]["kernels"] and not by_phase["outside"]["blocks"]:
        del by_phase["outside"]
    out = dict(phases=by_phase)
    if on_card:
        busy = sum(dur for _, _, dur in kernels) / 1e6
        flash = sum(ms for name, (ms, _) in top.items() if "flash_fwd_kernel" in name)
        out.update(wall_ms=wall_ms, device_busy_ms=busy,
                   device_idle_share=max(0.0, 1.0 - busy / wall_ms), flash_ms=flash,
                   kernels=[dict(name=name[:72], ms=ms, calls=n) for name, (ms, n) in
                            sorted(top.items(), key=lambda kv: kv[1][0], reverse=True)[:8]])
    return out


def train_full(cfg: dict, device: str) -> dict:
    """T1 ``train_full``: qwen2.5-3b at full width and depth in f32 (seeded
    random weights, remat on), b x s tokens from ``synth_batch``.  Checks
    first, from the first state and outside the counts: one forward and
    backward through the kernel held against the same through the plain
    attention (loss and grad_norm within ``loss_rtol`` / ``gnorm_rtol``),
    a second one through the kernel that must give the same loss and
    grad_norm bitwise (two gradients at full width, not two 49-GB states),
    and every layer's attention on the first pass's own inputs, kernel
    against plain, element by element (within ``attn_tol`` + ``attn_tol``
    x |plain|).
    Then the path: a warm step, ``timed_steps`` steps on the host clock
    ending in a synchronize, and one profiled step (``profile_train``);
    every step's loss and grad_norm finite and grad_norm > 0, flash launches
    a step (the forward's and remat's recompute's), peak memory.  Returns
    its record."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_torch
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.train_step import (TrainSettings, init_all, loss_and_grads,
                                              make_train_step)

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, _, wall = timers(on_card)
    free = (lambda: torch.cuda.empty_cache()) if on_card else (lambda: None)
    mcfg = smoke_config(cfg["arch"]) if cfg["smoke"] else get_config(cfg["arch"])
    n_attn = sum(k.startswith("attn") for k in mcfg.block_pattern) * mcfg.n_periods
    B, S = cfg["b"], cfg["s"]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    (params, opt), init_s = wall(lambda: init_all(mcfg, 0, device=device))
    n_params = M.param_count(params)
    check(n_params == cfg["params"], f"train_full: {n_params} parameters, not {cfg['params']}")
    state_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    dc = DataConfig(vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B)
    n_steps = 2 + cfg["timed_steps"]                       # warm, timed, profiled
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(dc, i).items()}
               for i in range(n_steps)]
    settings = TrainSettings(opt=AdamWConfig(**cfg["opt"]))

    def fwd_bwd(**kw):
        total, metrics, grads = loss_and_grads(params, mcfg, batches[0], settings, **kw)
        gnorm = global_norm(grads)
        del grads
        return total, metrics["loss"], gnorm

    captured = []

    def capture(q, k, v, **kw):
        """The default attention, keeping the forward's inputs (not remat's)."""
        if len(captured) < n_attn:
            captured.append((q.detach(), k.detach(), v.detach(), kw))
        return flash_attention_fwd(q, k, v, **kw)

    # the checks, from the first state, outside the counts
    with uncounted():
        c0 = stream_counts()["flash"]
        (tot_k, loss_k, gn_k), fb_s = wall(lambda: fwd_bwd(_attention=capture))
        per_fwd_bwd = stream_counts()["flash"] - c0
        (tot_2, loss_2, gn_2), fb2_s = wall(fwd_bwd)
        free()
        (tot_p, loss_p, gn_p), plain_s = wall(lambda: fwd_bwd(_attention=flash_attention_torch))
        free()
        # every layer's attention, at the training shape on the forward's
        # own inputs: the kernel against the plain version, element by
        # element, within phase 8's f32 tolerance
        tol, layer_err = cfg["attn_tol"], []
        for q, k, v, kw in captured:
            got, want = flash_attention_fwd(q, k, v, **kw), flash_attention_torch(q, k, v, **kw)
            diff = (got - want).abs()
            layer_err.append(float(diff.max()))
            check(bool((diff <= tol + tol * want.abs()).all()),
                  f"train_full: layer {len(layer_err) - 1}'s attention beyond {tol} of the "
                  f"plain version (max abs err {layer_err[-1]})")
            del got, want, diff
        attn_shape = list(captured[0][0].shape) if captured else None
        captured.clear()
        free()
    check(len(layer_err) == n_attn, f"train_full: {len(layer_err)} attention calls held, "
                                    f"not {n_attn}")
    check_peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    bitwise = bool(torch.equal(tot_k, tot_2) and torch.equal(gn_k, gn_2))
    check(bitwise, f"train_full: two backward passes from one state differ: grad_norm "
                   f"{float(gn_k)!r} vs {float(gn_2)!r}, loss {float(tot_k)!r} vs {float(tot_2)!r}")
    lk, lp, gk, gp = (float(x) for x in (loss_k, loss_p, gn_k, gn_p))
    check(abs(lk - lp) <= cfg["loss_rtol"] * abs(lp),
          f"train_full: loss kernel vs plain {lk} vs {lp} (rtol {cfg['loss_rtol']})")
    check(abs(gk - gp) <= cfg["gnorm_rtol"] * gp,
          f"train_full: grad_norm kernel vs plain {gk} vs {gp} (rtol {cfg['gnorm_rtol']})")
    if on_card:
        check(per_fwd_bwd == 2 * n_attn,
              f"train_full: {per_fwd_bwd} flash launches a forward and backward, not {2 * n_attn}")

    # the path: a warm step, timed steps, a profiled step
    step_fn = make_train_step(mcfg, settings=settings)
    state = {"opt": opt}
    history = []

    def step(i):
        _, state["opt"], m = step_fn(params, state["opt"], batches[i])
        history.append(m)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    c0 = stream_counts()["flash"]
    _, warm_s = wall(lambda: step(0))
    timed = [wall(lambda i=i: step(i))[1] for i in range(1, 1 + cfg["timed_steps"])]
    step_ms = float(np.mean(timed)) * 1e3
    where, profile_s = wall(lambda: profile_train(lambda: step(n_steps - 1), step_ms, on_card))
    where["seconds"] = profile_s
    flash_per_step = (stream_counts()["flash"] - c0) / n_steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    losses = [float(m["loss"]) for m in history]
    gnorms = [float(m["grad_norm"]) for m in history]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)) and min(gnorms) > 0,
          f"train_full: loss {losses} or grad_norm {gnorms} not finite and positive")
    if on_card:
        check(flash_per_step == 2 * n_attn,
              f"train_full: {flash_per_step} flash launches a step, not {2 * n_attn}")
    out = dict(arch=mcfg.name, n_layers=mcfg.n_layers, d_model=mcfg.d_model,
               heads=[mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_head], vocab=mcfg.vocab_size,
               dtype=mcfg.param_dtype, params=n_params, tied=mcfg.tie_embeddings,
               remat=settings.remat, opt=cfg["opt"], b=B, s=S, reduced=cfg["reduced"],
               init_seconds=init_s, state_gb=state_gb,
               checks=dict(fwd_bwd_ms=[fb_s * 1e3, fb2_s * 1e3], plain_fwd_bwd_ms=plain_s * 1e3,
                           loss_kernel=lk, loss_plain=lp, grad_norm_kernel=gk,
                           grad_norm_plain=gp, loss_rtol=cfg["loss_rtol"],
                           gnorm_rtol=cfg["gnorm_rtol"], grad_norm_bitwise_twice=bitwise,
                           attention_shape=attn_shape, attention_tol=cfg["attn_tol"],
                           attention_max_abs_err=max(layer_err),
                           attention_max_abs_err_by_layer=layer_err,
                           flash_launches_fwd_bwd=per_fwd_bwd, peak_gb=check_peak_gb),
               warm_step_ms=warm_s * 1e3, step_ms=[t * 1e3 for t in timed],
               mean_step_ms=step_ms, tokens_per_s=B * S / (step_ms / 1e3),
               peak_gb=peak_gb, flash_launches_per_step=flash_per_step,
               losses=losses, grad_norms=gnorms, lr=[float(m["lr"]) for m in history],
               profile=where)
    del params, state, opt, batches, history
    gc.collect()
    free()
    emit("train_full", **out)
    return out


def train_resume(cfg: dict, device: str) -> dict:
    """T2 ``train_resume``: the reference's kill/resume contract through
    ``launch/train.main`` on the device: ``steps`` steps straight, then
    again with ``--ckpt-every`` and ``--fail-at`` (``SystemExit``), then
    ``--resume``; the final losses equal, bitwise.  Then, outside the
    counts, ``compressed_mean_hook`` with error feedback over the smoke
    model's gradients (the run's weights at its start, ``hook_steps``
    batches): on the device and on the CPU, bitwise."""
    import tempfile

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.compression import compressed_mean_hook, init_ef_state
    from repro_torch.launch import train
    from repro_torch.models.convert import reference_layout
    from repro_torch.train.train_step import TrainSettings, init_all, loss_and_grads

    _, _, wall = timers(device == "cuda")
    argv = ["--arch", cfg["arch"], "--smoke", "--steps", str(cfg["steps"]), "--seq-len",
            str(cfg["seq_len"]), "--global-batch", str(cfg["global_batch"]), "--log-every",
            str(cfg["steps"]), "--device", device]
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ck = ["--ckpt-dir", root, "--ckpt-every", str(cfg["ckpt_every"])]
        straight, straight_s = wall(lambda: train.main(argv))
        try:
            train.main(argv + ck + ["--fail-at", str(cfg["fail_at"])])
            crashed = False
        except SystemExit:
            crashed = True
        check(crashed, "train_resume: --fail-at did not stop the run")
        resumed, resume_s = wall(lambda: train.main(argv + ck + ["--resume"]))
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    check(resumed == straight, f"train_resume: resumed {resumed!r} != straight {straight!r}")

    with uncounted():
        mcfg = smoke_config(cfg["arch"])
        params, _ = init_all(mcfg, 0, device=device)
        groups: dict = {}
        for name, (path, _) in reference_layout(params, mcfg).items():
            groups.setdefault(path, []).append(name)
        groups = list(groups.values())
        dc = DataConfig(vocab_size=mcfg.vocab_size, seq_len=cfg["seq_len"],
                        global_batch=cfg["global_batch"])
        ef_dev = ef_cpu = None
        same = True
        for i in range(cfg["hook_steps"]):
            batch = {k: torch.from_numpy(v).to(device) for k, v in synth_batch(dc, i).items()}
            _, _, grads = loss_and_grads(params, mcfg, batch, TrainSettings())
            if ef_dev is None:
                ef_dev = init_ef_state(grads)
                ef_cpu = {k: v.cpu() for k, v in ef_dev.items()}
            out_dev, ef_dev = compressed_mean_hook(grads, groups=groups, ef=ef_dev)
            out_cpu, ef_cpu = compressed_mean_hook({k: v.cpu() for k, v in grads.items()},
                                                   groups=groups, ef=ef_cpu)
            same &= all(torch.equal(out_dev[k].cpu(), out_cpu[k])
                        and torch.equal(ef_dev[k].cpu(), ef_cpu[k]) for k in out_cpu)
        del params
    check(same, "train_resume: compressed_mean_hook on the device differs from the CPU's")
    out = dict(arch=mcfg.name, smoke=True, steps=cfg["steps"], seq_len=cfg["seq_len"],
               global_batch=cfg["global_batch"], ckpt_every=cfg["ckpt_every"],
               fail_at=cfg["fail_at"], final_loss_straight=straight, final_loss_resumed=resumed,
               bitwise=resumed == straight, straight_seconds=straight_s,
               resume_seconds=resume_s,
               hook_ef_device_vs_cpu=dict(steps=cfg["hook_steps"], leaves=len(out_cpu),
                                          bitwise=same))
    emit("train_resume", **out)
    return out


def run_train(cfg: dict, device: str) -> dict:
    """The training path, launch counts zeroed just before and read just
    after (checks put theirs back): T1 ``train_full``, T2 ``train_resume``.
    Returns its counts by kernel row and its flash launches a step."""
    t0 = time.perf_counter()
    zero_counts()
    full = train_full(cfg["full"], device)
    train_resume(cfg["resume"], device)
    c = stream_counts()
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=0, frontier_wide_pruned=0,
                  distance=c["distance"], flash=c["flash"])
    emit("train_path_launches", **counts, seconds=time.perf_counter() - t0)
    check(c["frontier"] + c["frontier_pruned"] + c["frontier_wide"] + c["distance"] == 0,
          f"a frontier or distance launch on the train path: {c}")
    if device == "cuda":
        check(counts["flash"] > 0, "kernel flash never launched on the train path")
    return dict(counts=counts, per_pass=dict(train_step=full["flash_launches_per_step"]),
                t1={k: full[k] for k in ("losses", "grad_norms", "mean_step_ms", "peak_gb",
                                          "flash_launches_per_step")})


def train_sharded(cfg: dict, device: str, mesh, t1: dict) -> dict:
    """M1 ``train_sharded``: T1's model (seeded random weights), batches
    (``synth_batch`` steps 0, 1, ...) and optimizer through
    ``make_train_step(cfg, mesh, ...)`` on the one-rank mesh: as many steps
    as T1 ran (a warm one, timed ones, a profiled one), every loss and
    grad_norm bitwise T1's, flash launches a step (the forward's and
    remat's recompute's), peak memory, the profiled step's idle share."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainSettings, init_sharded, make_train_step

    on_card = device == "cuda"
    _, _, wall = timers(on_card)
    mcfg = smoke_config(cfg["arch"]) if cfg["smoke"] else get_config(cfg["arch"])
    n_attn = sum(k.startswith("attn") for k in mcfg.block_pattern) * mcfg.n_periods
    B, S = cfg["b"], cfg["s"]
    n_steps = len(t1["losses"])
    dc = DataConfig(vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in synth_batch(dc, i).items()}
               for i in range(n_steps)]
    settings = TrainSettings(opt=AdamWConfig(**cfg["opt"]))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    (params, opt), init_s = wall(lambda: init_sharded(mcfg, mesh, 0, device=device))
    step_fn, _ = make_train_step(mcfg, mesh, batches[0], settings)
    state = {"opt": opt}
    history = []

    def step(i):
        _, state["opt"], m = step_fn(params, state["opt"], batches[i])
        history.append(m)

    c0 = stream_counts()["flash"]
    _, warm_s = wall(lambda: step(0))
    timed = [wall(lambda i=i: step(i))[1] for i in range(1, n_steps - 1)]
    step_ms = float(np.mean(timed)) * 1e3
    where, profile_s = wall(lambda: profile_train(lambda: step(n_steps - 1), step_ms, on_card))
    where["seconds"] = profile_s
    flash_per_step = (stream_counts()["flash"] - c0) / n_steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    losses = [float(m["loss"]) for m in history]
    gnorms = [float(m["grad_norm"]) for m in history]
    check(losses == t1["losses"] and gnorms == t1["grad_norms"],
          f"train_sharded: losses {losses} / grad_norms {gnorms} are not T1's "
          f"{t1['losses']} / {t1['grad_norms']}")
    if on_card:
        check(flash_per_step == 2 * n_attn,
              f"train_sharded: {flash_per_step} flash launches a step, not {2 * n_attn}")
    out = dict(arch=mcfg.name, mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               backend=torch.distributed.get_backend(), b=B, s=S, steps=n_steps,
               init_seconds=init_s, warm_step_ms=warm_s * 1e3, step_ms=[t * 1e3 for t in timed],
               mean_step_ms=step_ms, t1_mean_step_ms=t1["mean_step_ms"],
               tokens_per_s=B * S / (step_ms / 1e3), peak_gb=peak_gb, t1_peak_gb=t1["peak_gb"],
               flash_launches_per_step=flash_per_step, losses=losses, grad_norms=gnorms,
               bitwise_t1=True, profile=where)
    del params, state, opt, batches, history
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    emit("train_sharded", **out)
    return out


def serve_sharded_phase(cfg: dict, device: str, mesh, lm_toks) -> dict:
    """M2 ``serve_sharded``: ``launch/serve.serve_sharded`` with
    ``--knn`` on the one-rank mesh (qwen2.5-3b, seeded weights, the mesh
    store), its tokens bitwise lm_serve's (the single-device ``launch/serve
    --knn`` on the same prompt and steps); ms a decode step and the wide
    frontier launches a step."""
    import numpy as np

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve
    args = serve.parser().parse_args(cfg["serve_argv"] + ["--device", device])
    mcfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    c0 = stream_counts()
    toks, store, timing = serve.serve_sharded(args, mcfg, mesh)
    c = {k: v - c0[k] for k, v in stream_counts().items()}
    check(np.array_equal(toks, lm_toks),
          f"serve_sharded: tokens {toks[0][:12]} are not lm_serve's {lm_toks[0][:12]}")
    out = dict(arch=mcfg.name, mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               batch=args.batch, prompt_len=args.prompt_len, steps=args.steps,
               store_keys=len(store.values), ms_per_decode_step=timing["ms_per_step"],
               prompt_feed_ms_per_token=timing["prefill_s"] * 1e3 / args.prompt_len,
               tokens_bitwise_lm_serve=True, sample=toks[0][:12].tolist(),
               wide_frontier_launches_per_step=c["frontier_wide"] / args.steps,
               frontier_launches_per_step=(c["frontier"] + c["frontier_pruned"]) / args.steps,
               pruned_launches_per_step=c["frontier_pruned"] / args.steps, launches=c)
    emit("serve_sharded", **out)
    return out


def sharded_decode_logits(cfg: dict, device: str, mesh) -> dict:
    """M2's logits check: the mesh builder's decode step (``ShardedLM.
    decode_step`` on the one-rank mesh) against the one-device
    ``M.decode_step`` on the same weights and inputs, every step's logits
    bitwise (one rank: every collective an identity).  The tokens fed are
    seeded random ones, one a step, not the model's greedy ones, which a
    random model repeats: every position's key and value then differ, so a
    cache written or read at the wrong position shows."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.parallel import ShardedLM
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_decode_step
    args = serve.parser().parse_args(cfg["serve_argv"] + ["--device", device])
    mcfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    n = args.prompt_len + args.steps
    model = M.init_params(mcfg, 0, device=device)
    sharded = ShardedLM.from_model(model, mcfg, mesh)
    fn, sh = make_decode_step(mcfg, mesh, ShapeSpec("serve", n, args.batch, "decode"))
    cache = sharded.init_cache(args.batch, n, sh["cache"])
    one = M.init_cache(mcfg, args.batch, n, device=device)
    fed = torch.from_numpy(np.random.default_rng(9).integers(
        0, mcfg.vocab_size, (args.batch, n)).astype(np.int32)).to(device)
    err, argmax_equal = 0.0, True
    with torch.no_grad():
        for pos in range(n):
            tok, got, cache = fn(sharded, fed[:, pos], cache, pos)
            want, one = M.decode_step(model, mcfg, fed[:, pos], one, pos)
            err = max(err, float((got.float() - want.float()).abs().max()))
            argmax_equal &= bool(torch.equal(tok, want.argmax(-1).to(torch.int32)))
    check(err == 0.0 and argmax_equal,
          f"sharded decode: logits {err} from the one-device decode's (tolerance 0)")
    out = dict(arch=mcfg.name, batch=args.batch, positions=n, max_abs_err=err,
               tolerance=0.0, cache_positions_a_rank=int(cache[0]["kv"][0].shape[2]),
               distinct_tokens_fed=int(torch.unique(fed).numel()))
    emit("serve_sharded_logits", **out)
    del model, sharded, cache, one
    gc.collect()
    return out


def device_busy(fn, wall_ms: float, on_card: bool = True) -> dict:
    """The card's busy ms in one ``fn()`` and its idle share of
    ``wall_ms``: torch.profiler with the CUDA activity alone (no host-side
    op records, whose cost on the ~10^5 launches of an xLSTM step
    ``profile_train`` pays), the kernels' durations summed from kineto's
    raw events.  None off the card."""
    import torch
    if not on_card:
        fn()
        return dict(device_busy_ms=None, device_idle_share=None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
               if "CUDA" in str(ev.device_type()) and not ev.is_user_annotation()) / 1e6
    return dict(device_busy_ms=busy, device_idle_share=max(0.0, 1.0 - busy / wall_ms))


def mesh_config(fcfg: dict, **over):
    """A family's config (full or smoke) with its overrides and ``over``."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    base = smoke_config(fcfg["arch"]) if fcfg["smoke"] else get_config(fcfg["arch"])
    return dataclasses.replace(base, **{**fcfg.get("overrides", {}), **over})


def serve_both(phase: str, argv: list, mcfg, device: str, mesh) -> dict:
    """``launch/serve``'s loop on one device (a check, outside the counts;
    its weights freed after it) and ``serve_sharded`` on the mesh with the
    same argv and seeded weights: tokens bitwise; ms a decode step and the
    wide launches a step of the mesh run."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import model as M
    args = serve.parser().parse_args(argv + ["--device", device])
    with uncounted():
        params = M.init_params(mcfg, 0, device=device)
        store = serve._build_store(args, mcfg, device)
        want, one = serve.serve_loop(args, mcfg, params, store)
        del params, store
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    c0 = stream_counts()
    toks, store, timing = serve.serve_sharded(args, mcfg, mesh)
    c = {k: v - c0[k] for k, v in stream_counts().items()}
    check(np.array_equal(toks, want),
          f"{phase}: serve_sharded tokens {toks[0][:12]} are not one device's {want[0][:12]}")
    del store
    return dict(batch=args.batch, prompt_len=args.prompt_len, steps=args.steps,
                ms_per_decode_step=timing["ms_per_step"],
                one_device_ms_per_decode_step=one["ms_per_step"], tokens_bitwise=True,
                sample=toks[0][:12].tolist(),
                wide_launches_per_step=c["frontier_wide"] / args.steps, launches=c)


def prefill_both(phase: str, mcfg, model, batch: dict, device: str, mesh) -> dict:
    """The prefill of ``batch`` on one device (a check, outside the counts;
    its logits kept on the host) and through ``make_prefill_step``'s mesh form on
    this rank's shards of the same weights (``ShardedLM.from_model``, which
    shares every whole tensor): logits bitwise; ms, peak GB, the idle
    share and the flash launches of the mesh run."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.parallel import ShardedLM
    from repro_torch.serve.serve_step import make_prefill_step
    on_card = device == "cuda"
    _, _, wall = timers(on_card)
    with uncounted():
        want = make_prefill_step(mcfg)(model, batch).cpu()
    sharded = ShardedLM.from_model(model, mcfg, mesh)
    b, s = batch["tokens"].shape
    fn, _ = make_prefill_step(mcfg, mesh, ShapeSpec("prefill", s, b, "prefill"))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    c0 = stream_counts()["flash"]
    got, ms = wall(lambda: fn(sharded, batch))
    flash = stream_counts()["flash"] - c0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    got = got.cpu()
    err = float((got - want).abs().max())
    check(got.shape == want.shape and torch.equal(got, want),
          f"{phase}: the mesh prefill's logits are {err} from one device's (tolerance 0)")
    del got, want
    with uncounted():
        again, ms2 = wall(lambda: fn(sharded, batch))
        del again
        where = device_busy(lambda: fn(sharded, batch), ms2 * 1e3, on_card)
    return dict(b=b, s=s, ms=[ms * 1e3, ms2 * 1e3], peak_gb=peak_gb, flash_launches=flash,
                max_abs_err=err, tolerance=0.0, **where)


def train_both(phase: str, mcfg, mesh, batches: list, opt: dict, device: str) -> dict:
    """The same steps from the same seeded weights on one device (a check,
    outside the counts) and through the mesh form of ``make_train_step``
    (``init_sharded``): every loss and grad norm bitwise.  Of the mesh run:
    the first step (warm), the timed ones, the last profiled
    (``device_busy``: its idle share), ms a step, tokens/s (the batch's
    token count over the mean timed step), peak GB, flash launches a
    step."""
    import numpy as np
    import torch

    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig
    on_card = device == "cuda"
    _, _, wall = timers(on_card)
    settings = TT.TrainSettings(opt=AdamWConfig(**opt))
    with uncounted():
        params, state = TT.init_all(mcfg, 0, device=device)
        step = TT.make_train_step(mcfg, settings=settings)
        want = []
        for bt in batches:
            params, state, m = step(params, state, bt)
            want.append((float(m["loss"]), float(m["grad_norm"])))
        del params, state, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    (params, state), init_s = wall(lambda: TT.init_sharded(mcfg, mesh, 0, device=device))
    step, _ = TT.make_train_step(mcfg, mesh, batches[0], settings)
    held = {"opt": state}
    hist = []

    def run(i):
        _, held["opt"], m = step(params, held["opt"], batches[i])
        hist.append(m)

    n = len(batches)
    c0 = stream_counts()["flash"]
    times = [wall(lambda i=i: run(i))[1] for i in range(n - 1)]
    step_ms = float(np.mean(times[1:] or times)) * 1e3
    where = device_busy(lambda: run(n - 1), step_ms, on_card)
    flash_per_step = (stream_counts()["flash"] - c0) / n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    got = [(float(m["loss"]), float(m["grad_norm"])) for m in hist]
    check(got == want, f"{phase}: mesh losses / grad norms {got} are not one device's {want}")
    tokens = int(np.prod(batches[0]["tokens"].shape))
    del params, held, state, hist
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(steps=n, init_seconds=init_s, warm_step_ms=times[0] * 1e3,
                step_ms=[t * 1e3 for t in times[1:]], mean_step_ms=step_ms,
                tokens_per_s=tokens / (step_ms / 1e3), peak_gb=peak_gb,
                flash_launches_per_step=flash_per_step, losses=[g[0] for g in got],
                grad_norms=[g[1] for g in got], bitwise_one_device=True, **where)


def mesh_families(cfg: dict, device: str, mesh) -> dict:
    """M3 on the one-rank mesh, each run held bitwise to the same run on one
    device: jamba-v0.1-52b's 8-layer period (``serve_sharded --knn``, the
    prefill at b x s; it does not train on the card: one period's
    parameters, gradients and moments are ~213 GB at full width),
    xlstm-1.3b (all 48 layers served through ``serve_sharded --knn``, steps
    of one 8-layer period), whisper-tiny (the forward, the cross K/V from
    the frames and cached decode steps, train steps).  Returns each
    phase's record and the flash launches of its passes."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.parallel import ShardedLM
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_decode_step

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, _, wall = timers(on_card)
    free = (lambda: torch.cuda.empty_cache()) if on_card else (lambda: None)
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    tokens_of = lambda v, s, b, i: torch.from_numpy(synth_batch(DataConfig(
        vocab_size=v, seq_len=s, global_batch=b), i)["tokens"]).to(dev)
    out = {}

    # jamba-v0.1-52b, one period: the prefill, then serving
    t0 = time.perf_counter()
    h = cfg["hybrid"]
    mcfg = mesh_config(h)
    model = M.init_params(mcfg, 0, device=device)
    pre = prefill_both("mesh_hybrid", mcfg, model,
                       {"tokens": tokens_of(mcfg.vocab_size, h["prefill_s"], h["prefill_b"], 0)},
                       device, mesh)
    del model
    gc.collect()
    free()
    srv = serve_both("mesh_hybrid", h["serve_argv"], mcfg, device, mesh)
    out["mesh_hybrid"] = dict(arch=mcfg.name, n_layers=mcfg.n_layers, mesh=mesh_shape,
                              prefill=pre, serve=srv, trains=False,
                              seconds=time.perf_counter() - t0)
    emit("mesh_hybrid", **out["mesh_hybrid"])
    gc.collect()
    free()

    # xlstm-1.3b: serving at full depth, then steps of one period
    t0 = time.perf_counter()
    x = cfg["xlstm"]
    mcfg = mesh_config(x)
    srv = serve_both("mesh_xlstm", x["serve_argv"], mcfg, device, mesh)
    gc.collect()
    free()
    tx = x["train"]
    tcfg = mesh_config(x, **tx["overrides"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=tx["s"], global_batch=tx["b"]), i).items()}
        for i in range(tx["steps"])]
    trn = train_both("mesh_xlstm", tcfg, mesh, batches, tx["opt"], device)
    trn.update(b=tx["b"], s=tx["s"], n_layers=tcfg.n_layers)
    out["mesh_xlstm"] = dict(arch=mcfg.name, n_layers=mcfg.n_layers, mesh=mesh_shape,
                             serve=srv, train=trn, seconds=time.perf_counter() - t0)
    emit("mesh_xlstm", **out["mesh_xlstm"])
    del batches
    gc.collect()
    free()

    # whisper-tiny: the forward, the cached decode, then training
    t0 = time.perf_counter()
    a = cfg["audio"]
    mcfg = mesh_config(a)
    B, S_enc, S = a["b"], a["frames"], a["tokens"]
    rng = np.random.default_rng(11)
    frames = lambda: torch.from_numpy(rng.standard_normal(
        (B, S_enc, mcfg.d_model)).astype(np.float32)).to(dev)
    fw = {"frames": frames(), "tokens": tokens_of(mcfg.vocab_size, S, B, 0)}
    model = M.init_params(mcfg, 0, device=device)
    fwd = prefill_both("mesh_audio", mcfg, model, fw, device, mesh)
    Ld = a["decode_steps"]
    fed = torch.from_numpy(np.random.default_rng(9).integers(
        0, mcfg.vocab_size, (B, Ld)).astype(np.int32)).to(dev)
    with uncounted():
        cache = encdec.encdec_prefill_cache(model, mcfg, fw["frames"],
                                            M.init_cache(mcfg, B, S_enc, device=device))
        want = []
        for pos in range(Ld):
            lg, cache = M.decode_step(model, mcfg, fed[:, pos], cache, pos)
            want.append(lg)
        del cache
    sharded = ShardedLM.from_model(model, mcfg, mesh)
    fn, sh = make_decode_step(mcfg, mesh, ShapeSpec("decode", S_enc, B, "decode"))
    c0 = stream_counts()["flash"]
    cache, cache_s = wall(lambda: sharded.prefill_cache(
        fw["frames"], sharded.init_cache(B, S_enc, sh["cache"])))
    per_cache = stream_counts()["flash"] - c0
    sync()
    t1 = time.perf_counter()
    err, argmax_equal = 0.0, True
    for pos in range(Ld):
        tok, lg, cache = fn(sharded, fed[:, pos], cache, pos)
        err = max(err, float((lg - want[pos]).abs().max()))
        argmax_equal &= bool(torch.equal(tok, want[pos].argmax(-1).to(torch.int32)))
    sync()
    dec_ms = (time.perf_counter() - t1) * 1e3 / Ld
    check(err == 0.0 and argmax_equal,
          f"mesh_audio: the mesh decode's logits are {err} from one device's (tolerance 0)")
    del model, sharded, cache, want, fw
    gc.collect()
    free()
    batches = [{"frames": frames(), "tokens": tokens_of(mcfg.vocab_size, S, B, i),
                "labels": torch.from_numpy(synth_batch(DataConfig(
                    vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B), i)["labels"]).to(dev)}
               for i in range(a["train_steps"])]
    trn = train_both("mesh_audio", mcfg, mesh, batches, a["opt"], device)
    trn.update(b=B, frames=S_enc, tokens=S)
    out["mesh_audio"] = dict(arch=mcfg.name, mesh=mesh_shape, forward=fwd,
                             prefill_cache=dict(ms=cache_s * 1e3, flash_launches=per_cache),
                             decode=dict(b=B, steps=Ld, ms_per_step=dec_ms, max_abs_err=err,
                                         tolerance=0.0, tokens_bitwise=argmax_equal),
                             train=trn, seconds=time.perf_counter() - t0)
    emit("mesh_audio", **out["mesh_audio"])
    del batches
    gc.collect()
    free()
    return out


def run_mesh(cfg: dict, device: str, t1: dict, lm_toks) -> dict:
    """The mesh path on a process group of one rank (NCCL on the card,
    gloo on the CPU; ``file://`` init in a temporary directory, destroyed
    at the end) and a (1, 1) {data, model} mesh, launch counts zeroed just
    before and read just after: M1 ``train_sharded``, M2
    ``serve_sharded``, M3 ``mesh_families`` (whose one-device references
    are checks, outside the counts); then M2's logits check
    (``sharded_decode_logits``, which launches no kernel).  Returns its
    counts by kernel row and its launches a pass."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{root}/rendezvous", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=device)
        zero_counts()
        m1 = train_sharded(cfg["train"], device, mesh, t1)
        m2 = serve_sharded_phase(cfg, device, mesh, lm_toks)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        m3 = mesh_families(cfg["families"], device, mesh)
        c = stream_counts()
        sharded_decode_logits(cfg, device, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    counts = dict(frontier=0, frontier_pruned=0, frontier_wide=c["frontier"],
                  frontier_wide_pruned=c["frontier_pruned"], distance=c["distance"],
                  flash=c["flash"])
    emit("mesh_path_launches", **counts, seconds=time.perf_counter() - t0,
         m3_seconds={k: v["seconds"] for k, v in m3.items()})
    if device == "cuda":
        check(c["frontier_wide"] == c["frontier"] + c["frontier_pruned"],
              f"a narrow frontier launch on the mesh path: {c}")
        for name in ("frontier_wide", "frontier_wide_pruned", "flash"):
            check(counts[name] > 0, f"kernel {name} never launched on the mesh path")
        torch.cuda.empty_cache()
    hy, xl, au = m3["mesh_hybrid"], m3["mesh_xlstm"], m3["mesh_audio"]
    return dict(counts=counts, per_pass=dict(
        train_step=m1["flash_launches_per_step"],
        decode_step_knn=m2["launches"]["frontier"] / m2["steps"],
        decode_step_knn_pruned=m2["launches"]["frontier_pruned"] / m2["steps"],
        hybrid_prefill=hy["prefill"]["flash_launches"],
        hybrid_decode_step_knn=hy["serve"]["launches"]["frontier"] / hy["serve"]["steps"],
        hybrid_decode_step_knn_pruned=(hy["serve"]["launches"]["frontier_pruned"]
                                       / hy["serve"]["steps"]),
        xlstm_decode_step_knn=xl["serve"]["launches"]["frontier"] / xl["serve"]["steps"],
        xlstm_decode_step_knn_pruned=(xl["serve"]["launches"]["frontier_pruned"]
                                      / xl["serve"]["steps"]),
        xlstm_train_step=xl["train"]["flash_launches_per_step"],
        audio_forward=au["forward"]["flash_launches"],
        audio_prefill_cache=au["prefill_cache"]["flash_launches"],
        audio_train_step=au["train"]["flash_launches_per_step"]))


# the new paths after the mesh path (run_dryrun, run_examples): one dry-run
# cell of every family on the 16 x 16 mesh (the full sweep, `python -m
# repro_torch.launch.dryrun --all --mesh both`, takes ~15 min and runs on its
# own), the long_500k skips of the eight full-attention archs, T1's cell at
# (1, 1) held against the card, the forest dry run's reference cell, and the
# four examples (the LM ones cut to 60 and 24 steps and one datastore batch)
DRYRUN_FULL = dict(
    cells=[("qwen2.5-3b", "prefill_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
           ("jamba-v0.1-52b", "long_500k"), ("xlstm-1.3b", "decode_32k"),
           ("whisper-tiny", "train_4k"), ("internvl2-1b", "prefill_32k")],
    skips=["codeqwen1.5-7b", "grok-1-314b", "internvl2-1b", "qwen2-moe-a2.7b",
           "qwen2.5-3b", "starcoder2-3b", "whisper-tiny", "yi-34b"],
    # T1: qwen2.5-3b in f32 (no padding), train b=2 x 2048, remat on
    t1=dict(arch="qwen2.5-3b", smoke=False, b=2, s=2048, params=3_085_938_688,
            cfg_extra=dict(param_dtype="float32", compute_dtype="float32", head_pad=0,
                           vocab_pad_to=1)),
    forest_argv=[], examples=dict(knnlm_argv=["--steps", "60", "--store-batches", "1"],
                                  train_steps=24))
# the most a block can hold beyond its tensor: the caching allocator does
# not split a cached block when at most 1 MiB would remain (kSmallSize)
ALLOC_SPLIT = 1 << 20


def dryrun_worker(cfg: dict, out: str, part: str) -> None:
    """The dry-run phase's cells, in a process of their own (each cell
    holds a fake default process group), one record each under ``out``:
    ``part`` "cells", ``cfg["cells"]`` on the 16 x 16 mesh and the
    long_500k cells of ``cfg["skips"]``; "t1", T1's cell at mesh (1, 1)
    tagged ``t1``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    if part == "cells":
        for arch, shape in cfg["cells"]:
            dryrun.run_cell(arch, shape, "pod", out_dir=out)
        for arch in cfg["skips"]:
            dryrun.run_cell(arch, "long_500k", "pod", out_dir=out)
        return
    t1 = cfg["t1"]
    dryrun.run_cell(t1["arch"], "t1", "1x1", tag="t1", out_dir=out, smoke=t1["smoke"],
                    shape=ShapeSpec("t1", t1["s"], t1["b"], "train"),
                    mesh=AbstractMesh(("data", "model"), (1, 1)), cfg_extra=t1["cfg_extra"])


def start_python(code: str, out_path: Path):
    """``python -c code`` with this checkout's ``src`` and root on the
    path, its output to ``out_path``."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), str(root)]),
               OMP_NUM_THREADS="1")
    f = open(out_path, "w")
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env, stdout=f,
                            stderr=subprocess.STDOUT), f


def finish(proc, f, out_path: Path, what: str, timeout: float) -> str:
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()
    text = out_path.read_text()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: {text[-3000:]}")
    return text


def dryrun_vs_card(cfg: dict, device: str, rec: dict, t1_ms: float) -> dict:
    """``dryrun_vs_card``: T1's cell (``rec``, the dry run's record at mesh
    (1, 1)) against the device.  (a) Its parameter and optimizer bytes
    against the growth of ``memory_allocated`` across ``init_all`` (each
    tensor rounded up to the allocator's 512 B at most); (b) its FLOPs,
    bytes and collective bytes against one real step of the same mesh
    program on the device under the same recorder (a one-rank process
    group: NCCL on the card, gloo on the CPU); (c) T1's measured ms a step
    against its bound and ``model_flops``."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
    from repro_torch.roofline import analysis as RA
    from repro_torch.train.train_step import init_all

    on_card = device == "cuda"
    t1 = cfg["t1"]
    base = smoke_config(t1["arch"]) if t1["smoke"] else get_config(t1["arch"])
    mcfg = dataclasses.replace(dryrun._bf16(base), **t1["cfg_extra"])
    shape = ShapeSpec("t1", t1["s"], t1["b"], "train")
    static = rec["static_memory"]
    want = static["params_bytes_dev"] + static["opt_bytes_dev"]
    # (a) bytes: the caching allocator's requested bytes grow by exactly the
    # dry run's bytes and the optimizer's int32 step; its allocated bytes by
    # those rounded up, to 512 B a block, and a block of more than 1 MiB
    # cut from a free block may keep up to 1 MiB more rather than split it
    def mem():
        if not on_card:
            return 0, 0
        st = torch.cuda.memory_stats()
        return st["requested_bytes.all.current"], st["allocated_bytes.all.current"]

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0, a0 = mem()
    params, opt = init_all(mcfg, 0, device=device)
    r1, a1 = mem()
    requested, grown = r1 - r0, a1 - a0
    n_tensors = len(list(params.parameters())) + len(opt.mu) + len(opt.nu) + 1
    n_params = sum(p.numel() for p in params.parameters())
    del params, opt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        check(requested == want + 4, f"dryrun_vs_card: init_all requested {requested} B, "
                                     f"the dry run says {want} B and the step's 4")
        check(0 <= grown - want <= ALLOC_SPLIT * n_tensors,
              f"dryrun_vs_card: init_all grew memory_allocated by {grown} B, the dry run "
              f"says {want} B (+ at most {ALLOC_SPLIT} B a tensor, {n_tensors} tensors)")
    check(n_params == rec["params"] and t1["params"] in (None, n_params),
          f"dryrun_vs_card: {n_params} parameters, the dry run's {rec['params']}")
    # (b) the counts of one real step under the same recorder
    root = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{root}/rendezvous", rank=0, world_size=1)
    try:
        run, _ = dryrun.build_cell(mcfg, shape, AbstractMesh(("data", "model"), (1, 1)),
                                   make_host_mesh(1, 1, device=device), device=device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card, _ = dryrun.count_step(run)
        if on_card:
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    meta = rec["counts"]
    same = {k: card[k] == meta[k] for k in ("flops", "bytes", "collectives", "kernels")}
    check(all(same.values()), f"dryrun_vs_card: the dry run's counts differ from the "
                              f"device's: {same}; meta {meta}; device {card}")
    # (c) T1's share of its bound
    roof = rec["roofline"]
    mf = RA.model_flops(mcfg, shape)
    peak = RA.PEAK_FLOP_PER_S[mcfg.compute_dtype]
    out = dict(arch=t1["arch"], b=t1["b"], s=t1["s"], dtype=mcfg.compute_dtype,
               static_bytes=want, requested_growth=requested, allocated_growth=grown,
               tensors=n_tensors, allocated_minus_static=grown - want, counts_equal=same,
               flops=card["flops"], bytes=card["bytes"], collectives=card["collectives"],
               kernels=card["kernels"], n_ops=card["n_ops"], step_seconds_recorded=step_s,
               peak_gb=peak_gb, model_flops=mf, model_flops_s=mf / peak,
               compute_s=roof["compute_s"], memory_s=roof["memory_s"],
               collective_s=roof["collective_s"], bound_s=roof["step_s"],
               bottleneck=roof["bottleneck"], t1_ms=t1_ms,
               t1_share_of_model_flops=(mf / peak) / (t1_ms / 1e3) if t1_ms else None,
               t1_share_of_bound=roof["step_s"] / (t1_ms / 1e3) if t1_ms else None,
               predicted=dict(model_flops=7.584e13, model_flops_s=1.132, share=0.42,
                              compute_s=[1.5, 1.7], memory_s="unknown"))
    emit("dryrun_vs_card", **out)
    return out


def run_dryrun(cfg: dict, device: str, t1_ms: float) -> tuple[dict, dict]:
    """The dry-run path and the examples.  ``dryrun_worker``'s cells run in
    two processes of their own (T1's cell in one, the others in the other;
    each cell holds a fake default process group; meta tensors, no card),
    started first and read last; meanwhile
    ``forest_dryrun`` (the reference's cell, rank 0's step on the device,
    in a process of its own too), then the examples (``run_examples``,
    counted apart); then ``dryrun`` (the cells' records) and
    ``dryrun_vs_card`` here.  The dry-run path's launches: the forest
    process's (from its record) and ``dryrun_vs_card``'s, counted from 0.
    Returns (the dry-run path's counts, the examples')."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_rec_"))
    workers, fproc = {}, (None, None)
    try:
        for part in ("t1", "cells"):
            workers[part] = start_python(f"import chip_smoke; chip_smoke.dryrun_worker("
                                         f"{cfg!r}, {str(out)!r}, {part!r})",
                                         out / f"dryrun_{part}.log")
        fargv = cfg["forest_argv"] + ["--device", device, "--out", str(out)]
        fproc = start_python(f"from repro_torch.launch import forest_dryrun; "
                             f"forest_dryrun.main({fargv!r})", out / "forest.log")
        flog = finish(*fproc, out / "forest.log", "forest_dryrun", 600)
        forest = json.loads((out / "forest_knn__base.json").read_text())
        check(forest["bitwise_vs_plain"], "forest_dryrun: not bitwise to the plain scorer")
        r = forest["roofline"]
        emit("forest_dryrun", **{k: forest[k] for k in (
            "n", "dim", "batch", "rank_batch", "k", "capacity", "frontier", "metric",
            "build_s", "device_ms", "height", "heights", "n_nodes_per_shard", "useful_flops",
            "bitwise_vs_plain", "launches")},
             compute_s=r["compute_s"], memory_s=r["memory_s"], collective_s=r["collective_s"],
             bottleneck=r["bottleneck"], roofline_frac=r["roofline_frac"],
             flops=r["flops"], bytes=r["bytes_accessed"], log=flog.strip().splitlines()[-1])
        examples = run_examples(cfg["examples"], device)
        for part, (proc, f) in workers.items():
            finish(proc, f, out / f"dryrun_{part}.log", f"the dry run's {part}", 900)
        recs = {p.stem: json.loads(p.read_text()) for p in out.glob("*__*.json")
                if not p.stem.startswith("forest_knn")}
        cells = {}
        for arch, shape in cfg["cells"]:
            rec = recs[f"{arch}__{shape}__pod"]
            check(rec["status"] == "ok", f"dryrun {arch} x {shape}: {rec.get('error')}")
            ro, st = rec["roofline"], rec["static_memory"]
            cells[f"{arch}/{shape}"] = dict(
                bottleneck=ro["bottleneck"], compute_s=ro["compute_s"],
                memory_s=ro["memory_s"], collective_s=ro["collective_s"],
                roofline_frac=ro["roofline_frac"], static_gb=st["total_bytes_dev"] / 1e9,
                of_gb=80, trace_s=rec["trace_s"], kernels=rec["counts"]["kernels"])
        from repro_torch.configs.base import SHAPES, get_config, shape_applicable
        reason = shape_applicable(get_config("qwen2.5-3b"), SHAPES["long_500k"])[1]
        for arch in cfg["skips"]:
            rec = recs[f"{arch}__long_500k__pod"]
            check(rec["status"] == "skipped" and rec["reason"] == reason,
                  f"dryrun {arch} x long_500k: {rec['status']}")
        emit("dryrun", mesh="pod", cells=cells, skipped=len(cfg["skips"]),
             skip_reason=reason, seconds=time.perf_counter() - t0)
        zero_counts()
        card = dryrun_vs_card(cfg, device, recs["qwen2.5-3b__t1__1x1__t1"], t1_ms)
        c = stream_counts()
    finally:
        for p, f in [fproc] + list(workers.values()):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
            if f is not None:
                f.close()
        shutil.rmtree(out, ignore_errors=True)
    fl = forest["launches"]
    counts = dict(frontier=c["frontier"] + fl["frontier"],
                  frontier_pruned=c["frontier_pruned"] + fl["frontier_pruned"],
                  frontier_wide=0, frontier_wide_pruned=0, distance=c["distance"],
                  flash=c["flash"])
    emit("dryrun_path_launches", **counts, seconds=time.perf_counter() - t0)
    if device == "cuda":
        check(c["frontier_wide"] == 0 and fl["frontier_wide"] == 0,
              f"a wide frontier launch on the dry-run path: {c}, {fl}")
        for name in ("frontier", "frontier_pruned", "flash"):
            check(counts[name] > 0, f"kernel {name} never launched on the dry-run path")
    return dict(counts=counts, per_pass=dict(
        train_step=card["kernels"]["flash_attention_fwd"]["calls"],
        forest_step=fl["per_step"])), examples


def run_examples(cfg: dict, device: str) -> dict:
    """The four examples on the device, launch counts zeroed just before
    and read just after: ``quickstart`` and ``distributed_index`` held
    against the same examples with ``--device cpu`` (the index is bitwise,
    so every kNN distance, id and page hit must agree), ``knnlm_serve``
    (through its ``validate()``), ``train_lm`` (its resumed final loss
    against an uninterrupted run of the same steps through
    ``launch/train.main``, bitwise).  The CPU runs and the uninterrupted
    run are checks, outside the counts."""
    from repro_torch.examples import distributed_index, knnlm_serve, quickstart, train_lm
    from repro_torch.launch import train
    t0 = time.perf_counter()
    dev = ["--device", device]
    zero_counts()
    got, secs = {}, {}
    for name, fn, argv in (("quickstart", quickstart.main, []),
                           ("distributed_index", distributed_index.main, []),
                           ("knnlm_serve", knnlm_serve.main, cfg["knnlm_argv"]),
                           ("train_lm", train_lm.main,
                            ["--steps", str(cfg["train_steps"])])):
        t = time.perf_counter()
        got[name] = fn(argv + dev)
        secs[name] = time.perf_counter() - t
    c = stream_counts()
    with uncounted():       # (a CPU rehearsal has no other device to hold them to)
        cpu = {} if device == "cpu" else {
            name: fn(["--device", "cpu"]) for name, fn in
            (("quickstart", quickstart.main), ("distributed_index", distributed_index.main))}
        straight = train.main(["--smoke", "--steps", str(cfg["train_steps"]), "--log-every",
                               "20"] + dev)
    for name in cpu:
        for key, v in cpu[name].items():
            check(got[name][key] == v, f"examples: {name}'s {key} differs from its CPU run")
    ks = got["knnlm_serve"]
    check(ks["evicted"] == ks["entries"] // 2, f"knnlm_serve evicted {ks['evicted']}")
    check(got["train_lm"] == straight,
          f"train_lm: resumed {got['train_lm']!r} != straight {straight!r}")
    counts = dict(frontier=c["frontier"], frontier_pruned=c["frontier_pruned"],
                  frontier_wide=0, frontier_wide_pruned=0, distance=c["distance"],
                  flash=c["flash"])
    same = bool(cpu)
    emit("examples", seconds=secs, quickstart=dict(same_as_cpu=same, **{
        k: got["quickstart"][k] for k in ("page_hits", "range_hits0", "ref_knn")}),
         distributed_index=dict(same_as_cpu=same, deleted=got["distributed_index"]["deleted"]),
         knnlm_serve=ks, train_lm=dict(steps=cfg["train_steps"], resumed=got["train_lm"],
                                       straight=straight, bitwise=True),
         launches=counts, total_seconds=time.perf_counter() - t0)
    if device == "cuda":
        check(c["frontier_wide"] == 0, f"a wide frontier launch in the examples: {c}")
        for name in ("frontier", "frontier_pruned", "distance", "flash"):
            check(counts[name] > 0, f"kernel {name} never launched by the examples")
    return dict(counts=counts, per_pass={})


def with_families(rows: list, fam: dict) -> list:
    """The ``kernels`` line's rows with each family phase's count under
    ``launches_by_path[phase]`` (``with_path``) and, on the flash and wide
    rows, its launches per pass."""
    per_row = {"flash_attention_fwd": (("prefill_forward", "prefill_forward"),
                                       ("prefill_cache", "prefill_cache"),
                                       ("step", "train_step"),
                                       ("hybrid_prefill", "hybrid_prefill"),
                                       ("xlstm_step", "xlstm_train_step"),
                                       ("audio_forward", "audio_forward"),
                                       ("audio_prefill_cache", "audio_prefill_cache"),
                                       ("audio_step", "audio_train_step")),
               "frontier_scores[wide]": (("decode_step_knn", "decode_step_knn"),
                                         ("hybrid_decode_step_knn", "hybrid_decode_step_knn"),
                                         ("xlstm_decode_step_knn", "xlstm_decode_step_knn")),
               "frontier_scores[wide,parent_prune]": (
                   ("decode_step_knn", "decode_step_knn_pruned"),
                   ("hybrid_decode_step_knn", "hybrid_decode_step_knn_pruned"),
                   ("xlstm_decode_step_knn", "xlstm_decode_step_knn_pruned"))}
    for phase, got in fam.items():
        rows = with_path(rows, got["counts"], phase)
        for row in rows:
            for name, key in per_row.get(row["name"], ()):
                if key in got["per_pass"]:
                    row["launches_per_pass"] = {**row["launches_per_pass"],
                                                f"{phase}:{name}": got["per_pass"][key]}
    return rows


def with_path(rows: list, counts: dict, path: str) -> list:
    """Every row of the ``kernels`` line with ``path``'s count (the stream
    path's, the serving path's) under ``launches_by_path[path]`` (the LM
    rows gain ``launches_by_path``, their slice's count under ``lm``);
    ``launches`` stays its slice's."""
    key = {"frontier_scores": "frontier", "frontier_scores[parent_prune]": "frontier_pruned",
           "frontier_scores[wide]": "frontier_wide",
           "frontier_scores[wide,parent_prune]": "frontier_wide_pruned",
           "pairwise_distance": "distance", "flash_attention_fwd": "flash"}
    out = []
    for row in rows:
        by_path = dict(row.get("launches_by_path", {"lm": row["launches"]}))
        by_path[path] = counts[key[row["name"]]] if row["name"] in key else 0
        out.append(dict(row, launches_by_path=by_path))
    return out


def with_forest(index_rows: list, forest: dict) -> list:
    """The index slice's rows with the forest pass added: ``launches``
    stays the index path's count, ``launches_by_path`` gives both passes,
    and the per-call counts of ``forest_knn`` and of the sharded scan join
    ``launches_per_pass``."""
    names = ("frontier", "frontier_pruned", "distance")
    per_pass = ({"forest_knn": forest["knn"]["frontier"]},
                {"forest_knn": forest["knn"]["frontier_pruned"]},
                {"brute_force_knn_sharded": forest["scan"]["distance"]})
    out = []
    for row, name, extra in zip(index_rows, names, per_pass):
        row = dict(row)
        by_path = {"index": row["launches"], "forest": forest["launches"][name]}
        row.update(launches_by_path=by_path,
                   launches_per_pass={**row["launches_per_pass"], **extra})
        out.append(row)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    index_rows = run(FULL, "cuda")
    torch.cuda.empty_cache()
    forest = run_forest(FOREST_FULL, "cuda")
    torch.cuda.empty_cache()
    ctx, (wide, wide_pruned, prune, flash) = run_lm(LM_FULL, "cuda")
    lm_toks = ctx["lm_toks"]   # M2's reference: run_stream keeps only what it needs
    torch.cuda.empty_cache()
    stream = run_stream(ctx, STREAM_FULL, "cuda")
    torch.cuda.empty_cache()
    serve = run_serve(ctx, SERVE_FULL, "cuda")
    ctx.clear()                # qwen2.5-3b's 12 GB and the datastores go
    gc.collect()
    torch.cuda.empty_cache()
    fam = run_lm_families(LM_FAMILIES_FULL, "cuda")
    gc.collect()               # every family's weights are gone
    torch.cuda.empty_cache()
    train = run_train(TRAIN_FULL, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mesh = run_mesh(MESH_FULL, "cuda", train["t1"], lm_toks)
    gc.collect()
    torch.cuda.empty_cache()
    dry, examples = run_dryrun(DRYRUN_FULL, "cuda", train["t1"]["mean_step_ms"])
    narrow, narrow_pruned, scan = with_forest(index_rows, forest)
    kernels = with_families(with_path(with_path(
        [narrow, narrow_pruned, wide, wide_pruned, scan, prune, flash], stream, "stream"),
        serve, "serve"), {**fam, "train": train, "mesh": mesh, "dryrun": dry,
                          "examples": examples})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
