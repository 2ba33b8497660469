"""``python -m repro_torch.launch.train`` on the CPU: the reference's
kill/resume contract, and checkpoints that cross between the packages.

A run killed by ``--fail-at`` and resumed from its checkpoint ends on the
uninterrupted run's loss bitwise (the reference's
``test_checkpoint.py::test_kill_resume_is_deterministic``, on the port).
A checkpoint that the JAX trainer writes after step 8 resumes in the port
to step 12, and the port's resumes in the JAX trainer; each ends within
1e-4 relative of the writer's own uninterrupted run (three steps of two
frameworks' f32 arithmetic apart; observed: equal to four decimals).
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist.checkpoint import latest_step, read_manifest  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--smoke", "--seq-len", "32", "--global-batch", "4", "--log-every", "100"]
CPU = ["--device", "cpu"]


def test_kill_resume_is_bitwise(tmp_path):
    n = ["--steps", "24"]
    straight = train.main(ARGV + n + CPU)
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="injected failure at step 13"):
        train.main(ARGV + n + CPU + ["--ckpt-dir", d, "--ckpt-every", "8", "--fail-at", "13"])
    assert sorted(os.listdir(d)) == ["step_00000009"]      # the save after step 8
    resumed = train.main(ARGV + n + CPU + ["--ckpt-dir", d, "--resume"])
    assert resumed == straight
    assert sorted(os.listdir(d))[-1] == "step_00000024"
    # nothing left to do from the final checkpoint
    assert train.main(ARGV + n + CPU + ["--ckpt-dir", d, "--resume"]) is None


def _write_and_resume(writer, reader, tmp_path, reader_argv=()):
    """``writer`` runs 12 steps straight, then again killed before step 9
    (its checkpoint: after step 8); ``reader`` resumes that checkpoint to
    step 12.  -> (the writer's straight loss, the reader's final loss)."""
    n = ARGV + ["--steps", "12"]
    straight = writer(n)
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit):
        writer(n + ["--ckpt-dir", d, "--ckpt-every", "8", "--fail-at", "9"])
    # the JAX trainer leaves its write to a background thread, which a
    # process joins at exit; here, wait for its commit
    deadline = time.monotonic() + 60
    while latest_step(d) is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert read_manifest(d)["step"] == 9
    return straight, reader(n + ["--ckpt-dir", d, "--resume", *reader_argv])


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    straight, resumed = _write_and_resume(jtrain.main, lambda a: train.main(a + CPU), tmp_path)
    assert abs(resumed - straight) <= 1e-4 * abs(straight), (resumed, straight)


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    straight, resumed = _write_and_resume(lambda a: train.main(a + CPU), jtrain.main, tmp_path)
    assert abs(resumed - straight) <= 1e-4 * abs(straight), (resumed, straight)
    # the port's checkpoint is the reference's tree leaf for leaf: the JAX
    # trainer restored it against its own template (leaf count, order, dtypes)
    m = read_manifest(str(tmp_path / "ck"), 12)
    assert m["leaves"][0] == {"dtype": "float32", "shape": [2, 2, 16]}   # opt/mu/blocks/0/attn/bk


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGV + ["--steps", "1"])


_RANK = """
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch import train
rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
try:
    print("LOSS", repr(train.main(["--smoke", "--steps", "2", "--device", "cpu"])))
finally:
    dist.destroy_process_group()
"""


def test_mesh_host_over_two_ranks_stops_naming_the_roadmap_item(tmp_path):
    """``--mesh host`` (the default) over two ranks no longer stops with
    an error that names ROADMAP item 17 (what this test once checked): it
    runs the sharded train step on a (1, 2) mesh, no rank names the
    roadmap, and both ranks end at the one-device run's loss (within 1e-5
    relative: the tensor-parallel sums reduce in another order)."""
    want = train.main(["--smoke", "--steps", "2"] + CPU)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_RANK), str(r), init],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "LOSS" in so, se[-2000:]
        assert "ROADMAP" not in so + se
        got = float(so.split("LOSS", 1)[1].split()[0])
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_encdec_and_vision_archs_are_refused():
    """The trainer once refused whisper-tiny and internvl2-1b, whose inputs
    go beside the tokens; it now feeds them (``data.pipeline.model_batch``:
    frames, image embeddings) and refuses only a ``--seq-len`` that leaves
    internvl2 no text after its image positions.  Two smoke steps of each
    end at a finite loss."""
    with pytest.raises(SystemExit):
        train.main(["--smoke", "--arch", "internvl2-1b", "--steps", "1", "--seq-len", "16"] + CPU)
    for arch in ("whisper-tiny", "internvl2-1b"):
        loss = train.main(["--smoke", "--arch", arch, "--steps", "2", "--seq-len", "32",
                           "--global-batch", "2", "--mesh", "single"] + CPU)
        assert np.isfinite(loss), arch


def test_checkpoint_leaves_are_the_reference_trees(tmp_path):
    """The port's checkpoint of a smoke qwen2.5-3b: the JAX trainer's
    template flattens to the same leaf table."""
    import jax

    from repro.configs.all_archs import smoke_config
    from repro.train.train_step import init_all
    d = str(tmp_path / "ck")
    train.main(ARGV + ["--steps", "2", "--ckpt-dir", d] + CPU)
    params, opt = init_all(smoke_config("qwen2.5-3b"), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves({"params": params, "opt": opt._asdict()})
    m = read_manifest(d, 2)
    assert [(x["dtype"], tuple(x["shape"])) for x in m["leaves"]] == \
        [(str(np.asarray(x).dtype), tuple(x.shape)) for x in leaves]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_ranks(argv: list, world: int = 2, timeout: int = 180) -> list:
    """``launch/train`` on ``world`` rank subprocesses that start their
    group from the ``torch.distributed`` environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; gloo on the CPU);
    each prints ``LOSS <its return>`` if it ends.  -> [(returncode,
    stdout, stderr)] by rank."""
    code = ("import sys; from repro_torch.launch import train; "
            "print('LOSS', repr(train.main(sys.argv[1:])))")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, so, se) for p, (so, se) in zip(procs, outs)]


def test_mesh_run_from_the_environment_resumes_on_one_device(tmp_path):
    """Two ranks that start their group from the ``torch.distributed``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    gloo on the CPU) run ``--mesh host`` on a (1, 2) mesh, are killed at
    step 3 after a checkpoint, and one device resumes the checkpoint (the
    full tree, rank 0's) to step 4: its loss is the uninterrupted one-device
    run's within 1e-5 relative (steps 0-2 ran tensor-parallel)."""
    n = ["--steps", "4"]
    straight = train.main(ARGV + n + CPU)
    d = str(tmp_path / "ck")
    argv = ARGV + n + CPU + ["--ckpt-dir", d, "--ckpt-every", "2", "--fail-at", "3"]
    for rc, so, se in _env_ranks(argv):
        assert rc != 0 and "injected failure at step 3" in se, se[-2000:]
    assert latest_step(d) == 3
    resumed = train.main(ARGV + n + CPU + ["--ckpt-dir", d, "--resume"])
    assert abs(resumed - straight) <= 1e-5 * abs(straight), (resumed, straight)


def test_mesh_run_resumes_on_its_mesh(tmp_path):
    """Four ranks on a (2, 2) mesh (FSDP and ZeRO-1 over 'data': each
    data rank holds the moments of one of the two layers) are killed at
    step 3 after a checkpoint and resume on the same mesh, each rank
    reading its own shards of every leaf (``restore_checkpoint(
    shardings=)``): every rank ends step 4 at the uninterrupted one-device
    run's loss within 1e-5 relative."""
    n = ["--steps", "4"]
    straight = train.main(ARGV + n + CPU)
    d = str(tmp_path / "ck")
    argv = ARGV + n + CPU + ["--ckpt-dir", d, "--ckpt-every", "2"]
    for rc, so, se in _env_ranks(argv + ["--fail-at", "3"], world=4):
        assert rc != 0 and "injected failure at step 3" in se, se[-2000:]
    assert latest_step(d) == 3
    outs = _env_ranks(argv + ["--resume"], world=4)
    assert "resumed from step 3" in outs[0][1]
    for rc, so, se in outs:
        assert rc == 0 and "LOSS" in so, se[-2000:]
        got = float(so.split("LOSS", 1)[1].split()[0])
        assert abs(got - straight) <= 1e-5 * abs(straight), (got, straight)
