"""
One run of one cell: set-up, a closed-loop window of steps, the end-to-end
metrics, with ``trace`` the per-layer metrics from the profiler's trace,
and the check that decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (scene, frame, disc, map);
- ``traffic/<traffic>.json``: the mix's parameters, with ``driver``, the
  name of the step driver ``traffic/<driver>.py``;
- ``workloads/<cell>.json``: the cell's check (how much it compares, and
  the limit of each number compared);
- ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None``.

A driver module has ``setup(ctx) -> state`` (the program's set-up and the
warm-up of every shape the window uses), ``step(state, i)`` (one user
call), ``release(state)`` (drops the program's state, keeping what the
check compares), ``check(state) -> {name: value}`` and ``work(state) ->
dict`` (the least work of the kernels that a step drives, for the roofline
readers). ``ctx.stand_in`` replaces the program by another entry: the
reference in float32 (``'control'``) or a broken program (the tests).
"""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

#: Seconds of the window that a traced run records
TRACE_SECONDS = 10.0
#: Top-level module names that no run may load
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'planetmapper_tpu')


def load_module(path: Path, name: str):
    """Import a driver or reader by its file path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item['name'] == name:
            return item
    raise SystemExit(f'no {what} named {name!r} in BENCHMARK.json')


def cell_files(bench: dict, workload: str) -> SimpleNamespace:
    """The cell's entry and the files that its names point to."""
    cell = find(bench['workloads'], workload, 'workload')
    config = find(bench['configs'], cell['config'], 'config')
    traffic = load_json(HERE / 'traffic' / f'{cell["traffic"]}.json')
    return SimpleNamespace(
        cell=cell, config=load_json(ROOT / config['file']), traffic=traffic,
        check=load_json(HERE / 'workloads' / f'{workload}.json'),
        driver=load_module(HERE / 'traffic' / f'{traffic["driver"]}.py',
                           f'port_bench_driver_{traffic["driver"]}'),
    )


def metrics_for(entries: list, workload: str) -> list:
    return [m for m in entries if workload in m.get('workloads', [workload])]


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split('.')[0] in FORBIDDEN_MODULES})


class Reservoir:
    """
    A seeded uniform sample of ``k`` of the steps offered (all of them
    while fewer have come). ``offer`` returns the slot (0 to ``k - 1``)
    that the step takes, or None: the driver copies what it keeps into its
    slot, so that keeping allocates nothing in the window.
    """

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.seen = 0
        self.steps = [None] * k

    def offer(self, index: int):
        self.seen += 1
        slot = (self.seen - 1 if self.seen <= self.k
                else int(self.rng.integers(self.seen)))
        if slot >= self.k:
            return None
        self.steps[slot] = index
        return slot

    def filled(self) -> list[int]:
        """The slots that hold a step."""
        return [j for j, i in enumerate(self.steps) if i is not None]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = 'cuda', t_start: float | None = None,
             overrides: dict | None = None, stand_in=None,
             steps: int | None = None) -> dict:
    """
    One run of ``workload``; returns the result line as a dict.
    ``overrides`` replaces entries of the configuration and the traffic
    (``{'config': {...}, 'traffic': {...}}``, the tests' small sizes);
    ``steps`` runs that many steps in place of a timed window.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(ROOT / 'BENCHMARK.json')
    files = cell_files(bench, workload)
    overrides = overrides or {}
    config = dict(files.config, **overrides.get('config', {}))
    traffic = dict(files.traffic, **overrides.get('traffic', {}))
    cuda = torch.device(device).type == 'cuda'
    kernel_dir = tempfile.mkdtemp(prefix='port_bench_kernels_')
    try:
        ctx = SimpleNamespace(
            config=config, traffic=traffic, check=files.check,
            seed=int(seed), device=torch.device(device), cuda=cuda,
            kernel_dir=kernel_dir, stand_in=stand_in, Reservoir=Reservoir,
        )
        driver = files.driver
        state = driver.setup(ctx)
        sync(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        window = run_window(driver, state, seconds, steps, trace, cuda)
        q = np.percentile(window.latencies_ms, [0, 25, 50, 75, 100])
        print(f'{window.steps} steps in {window.seconds:.3f} s; step ms '
              'min/25/50/75/max ' + ' '.join(f'{v:.3f}' for v in q),
              file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        driver.release(state)
        if cuda:
            torch.cuda.empty_cache()
        checks = driver.check(state)
        for note in getattr(state, 'notes', []):
            print(note, file=sys.stderr)
    finally:
        shutil.rmtree(kernel_dir, ignore_errors=True)

    limits = files.check['limits']
    checked = {name: dict(value=float(value), limit=float(limits[name]))
               for name, value in checks.items()}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit']
                  for c in checked.values())
    name = torch.cuda.get_device_name(0) if cuda else 'cpu'
    result = dict(
        correct=correct, attempted=window.steps, failed=0, metrics={},
        device=dict(platform='gpu' if cuda else 'cpu', kind=name, count=1,
                    memory_peak_bytes=int(peak)),
    )
    if trace:
        from . import tracing

        ctx.work = driver.work(state)
        ctx.window = window
        result['metrics'] = tracing.per_layer(bench, workload, ctx)
        result['device'].update(busy_s=window.trace.busy_s,
                                window_s=window.trace.window_s)
        result['breakdown'] = window.trace.breakdown()
    else:
        values = dict(
            step_ms=window.seconds * 1e3 / window.steps,
            step_p95_ms=percentile(window.latencies_ms, 95),
            peak_mem_gib=peak / 2**30,
            setup_s=setup_s,
        )
        for m in metrics_for(bench['end_to_end'], workload):
            result['metrics'][m['name']] = dict(value=values[m['name']],
                                                unit=m['unit'])
    result['checks'] = checked
    return result


def sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def run_window(driver, state, seconds, steps, trace, cuda) -> SimpleNamespace:
    """
    The closed loop: each step is one user call ended by a synchronise,
    and the next starts when it has returned. The window lasts ``seconds``
    (its last step finishes after it) or ``steps`` steps. With ``trace``
    the profiler records its first :data:`TRACE_SECONDS` (the ``window``
    span); the rest runs untraced, so that reading the trace stays short
    in a cell of thousands of steps.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    latencies = []

    def loop(until, last):
        while (len(latencies) < last) if steps is not None else (
                not latencies or time.perf_counter() < until):
            t = time.perf_counter()
            with record_function('step'):
                driver.step(state, len(latencies))
                with record_function('sync'):
                    sync(cuda)
            latencies.append((time.perf_counter() - t) * 1e3)

    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_data = None
    if trace:
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function('window'):
                loop(min(deadline, t0 + TRACE_SECONDS), steps or 0)
        traced_steps = len(latencies)
        from . import tracing

        trace_data = tracing.Trace(prof)
        trace_data.steps = traced_steps
    loop(deadline, steps or 0)
    return SimpleNamespace(steps=len(latencies),
                           seconds=time.perf_counter() - t0,
                           latencies_ms=latencies, trace=trace_data)


def summary_lines(result: dict) -> list[str]:
    """Each number compared, beside its limit."""
    return [f'check {name}: {c["value"]!r} (limit {c["limit"]!r})'
            for name, c in result['checks'].items()]
