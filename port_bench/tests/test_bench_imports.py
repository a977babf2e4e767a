"""
What the benchmark loads: nothing whose top-level name (the part before the
first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``planetmapper_tpu`` in a run, and the reference loads nothing of the
program, ``planetmapper_tpu_torch``, either. Each in a fresh interpreter.
"""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

JAX = {'jax', 'jaxlib', 'flax', 'planetmapper_tpu'}


def _top_level_modules(code: str) -> set[str]:
    script = (f'import sys, json; sys.path.insert(0, {str(ROOT)!r})\n' + code
              + '\nprint(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    loaded = _top_level_modules(
        'import port_bench.reference.scene, port_bench.reference.backplanes, '
        'port_bench.reference.maps, port_bench.reference.compare')
    assert not loaded & (JAX | {'planetmapper_tpu_torch'})


def test_a_run_loads_no_jax():
    loaded = _top_level_modules(
        'from port_bench import harness\n'
        'from port_bench.tests.conftest import small\n'
        "harness.run_cell('jupiter_2048.map_linear', 3, 0.0, True, "
        "device='cpu', overrides=small('jupiter_2048.map_linear'), steps=2)\n"
        'assert not harness.forbidden_loaded()')
    assert 'planetmapper_tpu_torch' in loaded
    assert not loaded & JAX


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload',
         'jupiter_2048.backplanes', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ''


def test_a_run_fails_without_the_program(tmp_path):
    """In a checkout that holds only BENCHMARK.json and port_bench/."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'port_bench', tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    script = (f'import sys; sys.path.insert(0, {str(tmp_path)!r})\n'
              'from port_bench import harness\n'
              'from port_bench.tests.conftest import small\n'
              "harness.run_cell('jupiter_2048.backplanes', 1, 0.0, False, "
              "device='cpu', overrides=small('jupiter_2048.backplanes'), steps=1)")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert 'planetmapper_tpu_torch' in out.stderr
