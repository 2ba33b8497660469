"""Work that module fixtures compute once per test run, not once per
pytest-xdist worker (pytest-xdist's documented pattern for session data).

Under xdist every worker that runs a test of a module sets the module's
fixtures up again, so a fixture that starts rank subprocesses or compiles
the JAX references would run once on each of them.  Here each piece of
such work has a name and leaves its files in the run's shared temporary
root (``shared_root``): the first worker to take the piece's
``fcntl.flock`` lock computes it and marks it done, every other one waits
on the lock and finds the mark.  A piece that raised leaves no mark, so
the next worker computes it again.
"""
import contextlib
import fcntl
import os


def shared_root(tmp_path_factory):
    """The directory every worker of this test run shares: the parent of a
    worker's base temporary directory under xdist, the run's own base
    directory without it."""
    root = tmp_path_factory.getbasetemp()
    return root.parent if os.environ.get("PYTEST_XDIST_WORKER") else root


def worker_offset(n: int) -> int:
    """Where this worker starts in a list of ``n`` pieces, so that workers
    that arrive together take different pieces first (0 without xdist)."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    count = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return int(worker.removeprefix("gw")) * n // max(count, 1) % n


def done(root, name: str) -> bool:
    return (root / f"{name}.done").exists()


def once(root, name: str, produce) -> None:
    """``produce()`` unless piece ``name`` is done, under its lock (waiting
    for a worker that holds it), then its mark."""
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done(root, name):
                produce()
                (root / f"{name}.done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@contextlib.contextmanager
def claim(root, name: str):
    """Take piece ``name`` without waiting: yields True when this worker
    holds its lock and the piece is not done (the body computes it and the
    mark follows when the body returns), False otherwise (another worker
    holds it, or it is done: ``once`` waits for it later)."""
    with open(root / f"{name}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            yield False
            return
        try:
            mine = not done(root, name)
            yield mine
            if mine:
                (root / f"{name}.done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
