"""One run of one cell: find its files by name, hand its driver the
configuration and the traffic mix, and turn what the driver measured into
the result line.

A driver (``drivers/<traffic kind>.py``) builds the system from the
configuration and ``--seed``, warms up, calls ``ctx.open_window()`` just
before its first timed operation, drives the traffic until
``ctx.window.t_close``, then checks what the timed path produced against
the plain reference and returns an ``Outcome``.  A traced run
(``--trace 1``) splits the window into thirds: the first runs bare, the
second with the port's counters and spans on (and any synchronising laps
the driver takes), the third under the profiler.  No instrument then
distorts what another reads, and the bare third gives the whole-step
rates.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of ``workload``, each read from
    its own file: the configuration's ``file`` and ``traffic/<name>.json``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in spec["configs"]}
    with open(ROOT / cfgs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name (the part
    before the first dot, compared whole) is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), the start of
    ``setup_s``."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, beside its limit
    (the run is correct where every number is at most its limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    e2e: dict                 # end-to-end metric name -> value
    checks: list              # [Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    sources: dict = dataclasses.field(default_factory=dict)   # per-layer inputs


class Window:
    """The measured window and, in a traced run, its three phases.
    Drivers call ``tick(now)`` as they go (phase changes happen there) and
    ``close(now)`` once the window's work is done."""

    def __init__(self, t_open: float, seconds: float, trace: bool, obs_counters: bool,
                 on_card: bool):
        self.t_open, self.seconds = t_open, seconds
        self.t_close = t_open + seconds
        self.trace, self.obs_counters, self.on_card = trace, obs_counters, on_card
        self.phase = 0
        third = seconds / 3
        self.bounds = (t_open + third, t_open + 2 * third)
        self.sources: dict = {}
        self._dt = None

    @property
    def counting(self) -> bool:
        """True in the traced run's second third (counters, spans, laps)."""
        return self.trace and self.phase == 1

    def tick(self, now: float) -> None:
        if not self.trace:
            return
        if self.phase == 0 and now >= self.bounds[0]:
            self.phase = 1
            self.sources["counting_t0"] = now
            if self.obs_counters:
                from repro_torch import obs
                obs.reset()
                obs.enable()
        if self.phase == 1 and now >= self.bounds[1]:
            self._end_counting(now)
            self.phase = 2
            if self.on_card:
                from perfbench.profiling import DeviceTrace
                self._dt = DeviceTrace()
                self._dt.start()

    def _end_counting(self, now: float) -> None:
        self.sources["counting_t1"] = now
        if self.obs_counters:
            from repro_torch import obs
            self.sources["obs"] = dict(obs.REGISTRY.snapshot())
            self.sources["spans"] = obs.RECORDER.spans()
            obs.disable()

    def close(self, now: float) -> None:
        if not self.trace:
            return
        if self.phase == 1:
            self._end_counting(now)
        if self._dt is not None:
            self.sources["trace"] = self._dt.stop()
            self._dt = None
        self.phase = 3


class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    window it opens."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device: str, control: bool = False):
        self.cell, self.config, self.traffic = cell, config, traffic
        # control: also work out the numbers the control gives (the plain
        # reference in the next lower precision, put in the program's
        # place); only the control's script and tests ask for it
        self.control = control
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.on_card = device != "cpu"
        self.setup_s = None
        self.window: Window | None = None

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def open_window(self, *, obs_counters: bool = False) -> Window:
        """Call with the card idle, just before the first timed operation:
        set-up ends here."""
        if self.trace and self.on_card:
            from perfbench.profiling import warm_up
            warm_up()
        self.sync()
        self.setup_s = process_age_s()
        self.window = Window(time.perf_counter(), self.seconds, self.trace, obs_counters,
                             self.on_card)
        return self.window

    def memory_peak(self) -> int:
        if not self.on_card:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str, spec: dict) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:       # an end-to-end metric without a list: every cell
        return True
    e2e = {m["name"]: m for m in spec["end_to_end"]}[moves]
    return _applies(e2e, workload, spec)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", spec: dict | None = None, overrides: dict | None = None,
             device_kind: str | None = None, control: bool = False,
             outcome: list | None = None) -> tuple[dict, list]:
    """Run ``workload`` once.  Returns (the result line as a dict, its
    checks).  ``overrides`` ({"config": {...}, "traffic": {...}}) replace
    keys of the cell's files: the CPU tests' tiny sizes, never used by
    ``run.py``; so is ``control`` (see ``Context``).  ``outcome``, a list,
    gets the driver's ``Outcome`` appended."""
    spec = spec or load_spec()
    cell, config, traffic = find_cell(spec, workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    ctx = Context(cell, config, traffic, seed, seconds, trace, device, control)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    out: Outcome = driver.run(ctx)
    if outcome is not None:
        outcome.append(out)
    if trace:
        srcs = {**ctx.window.sources, **out.sources}
        metrics = {}
        for m in spec["per_layer"]:
            if _applies(m, workload, spec):
                v = _reader(m["name"])(srcs)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            if _applies(m, workload, spec):
                v = ctx.setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": all(c.ok for c in out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics,
            "device": {"platform": "gpu" if ctx.on_card else "cpu",
                       "kind": device_kind or device, "count": int(cell["chips"]),
                       "memory_peak_bytes": int(out.memory_peak_bytes)}}
    if trace:
        tr = ctx.window.sources.get("trace")
        if tr is not None:
            line["device"]["busy_s"] = tr["busy_s"]
            line["device"]["window_s"] = tr["window_s"]
            line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line, out.checks
