"""BENCHMARK.json against the benchmark's contract: every name it gives is
a file of its own, and names, units and entries keep to their rules."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
HERE = ROOT / 'port_bench'
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


def test_top_level_keys_and_paths():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['port_bench']
    for path in BENCH['paths']:
        assert PATH.match(path) and not path.startswith('/') and '..' not in path
    assert BENCH['command'] == ['python3', 'port_bench/run.py']
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize('entry', BENCH['configs'], ids=lambda e: e['name'])
def test_config_is_a_file(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(entry['name'])
    assert entry['file'] == f'port_bench/configs/{entry["name"]}.json'
    config = json.loads((ROOT / entry['file']).read_text())
    assert config['name'] == entry['name']
    assert config['reduced'] == entry['reduced'] == []
    assert 1 <= len(entry['source']) <= 200 and 1 <= len(entry['why']) <= 200


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda c: c['name'])
def test_cell_files(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    for key in ('name', 'config', 'traffic'):
        assert NAME.match(cell[key])
    assert cell['chips'] == 1
    assert 1 <= len(cell['why']) <= 200 and '\n' not in cell['why']
    assert cell['config'] in {c['name'] for c in BENCH['configs']}
    traffic = json.loads((HERE / 'traffic' / f'{cell["traffic"]}.json').read_text())
    assert (HERE / 'traffic' / f'{traffic["driver"]}.py').is_file()
    check = json.loads((HERE / 'workloads' / f'{cell["name"]}.json').read_text())
    assert check['limits'] and all(v >= 0 for v in check['limits'].values())


@pytest.mark.parametrize('metric', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_entries(metric):
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    cells = {c['name'] for c in BENCH['workloads']}
    assert set(metric.get('workloads', [])) <= cells
    if metric in BENCH['end_to_end']:
        assert set(metric) <= {'name', 'unit', 'better', 'bound', 'source',
                               'workloads'}
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    else:
        assert set(metric) <= {'name', 'unit', 'better', 'source', 'layer',
                               'moves', 'workloads'}
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')
        assert (HERE / 'metrics' / f'{metric["name"]}.py').is_file()
        assert metric['moves'] in {m['name'] for m in BENCH['end_to_end']}
        if 'roofline' in metric['name']:
            assert metric['name'].endswith('_roofline') and metric['unit'] == '%'


def test_names_are_unique():
    for key in ('configs', 'workloads'):
        names = [e['name'] for e in BENCH[key]]
        assert len(names) == len(set(names))
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    pairs = [(c['config'], c['traffic']) for c in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda c: c['name'])
def test_each_cell_reports_what_the_contract_asks(cell):
    def reported(metrics):
        return [m for m in metrics if cell['name'] in m.get('workloads', [cell['name']])]

    e2e = {m['name'] for m in reported(BENCH['end_to_end'])}
    assert 'setup_s' in e2e and len(e2e) >= 2 and 'step_ms' in e2e
    layer = reported(BENCH['per_layer'])
    assert layer and all(m['moves'] in e2e for m in layer)


def test_config_names_every_key_the_drivers_read():
    for entry in BENCH['configs']:
        config = json.loads((ROOT / entry['file']).read_text())
        for key in ('target', 'observer', 'utc', 'frame', 'disc', 'map',
                    'aberration_correction', 'assumed'):
            assert key in config
