"""
The check that decides ``correct``, driven through the rest of a run with
the harness's look for a card skipped (the CPU at the small sizes): the
sound program passes; the control (the reference in float32 in the
program's place) and each fault a cell can have, planted under the timed
path, come out not correct. On a card, the control at each cell's own
size comes out not correct on three seeds.
"""

import numpy as np
import pytest
import torch

from conftest import CELLS, SEED, small
from port_bench import control, harness

def _run(workload, stand_in=None, steps=3):
    return harness.run_cell(workload, SEED, 0.0, False, device='cpu',
                            overrides=small(workload), stand_in=stand_in,
                            steps=steps)


def _altered(entry):
    """An answer altered where it is produced: every value of one plane,
    or of the map, moved."""
    def broken(*args):
        out = entry(*args)
        if isinstance(out, dict):
            out = dict(out)
            out['EMISSION'] = np.asarray(out['EMISSION']) + 1.0
            return out
        return out + 1e-3

    return broken


def _half_left_out(entry):
    """Half of the batch left out: the second half of the rows of a frame's
    planes, or of a map, NaN."""
    def broken(*args):
        out = entry(*args)
        if isinstance(out, dict):
            out = {k: np.array(v, dtype=v.dtype) for k, v in out.items()}
            for v in out.values():
                v[v.shape[0] // 2:] = np.nan
            return out
        out = out.clone()
        out[out.shape[0] // 2:] = float('nan')
        return out

    return broken


def _block_altered(entry):
    """An answer altered in one block where it is produced: a 8x32 block at
    the frame's last pixel (ANGULAR-X, finite everywhere, by 1e-3 arcsec),
    or at the map's last finite value (by 1e-3)."""
    def broken(*args):
        out = entry(*args)
        if isinstance(out, dict):
            out = dict(out)
            v = np.array(out['ANGULAR-X'])
            v[-8:, -32:] += 1e-3
            out['ANGULAR-X'] = v
            return out
        out = out.clone()
        i, j = (int(v) for v in torch.isfinite(out).nonzero()[-1])
        out[max(i - 7, 0):i + 1, max(j - 31, 0):j + 1] += 1e-3
        return out

    return broken


@pytest.mark.parametrize('workload', CELLS)
def test_the_sound_program_is_correct(workload):
    assert _run(workload)['correct']


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('fault', [_altered, _half_left_out, _block_altered],
                         ids=['answer_altered', 'half_left_out', 'block_altered'])
def test_a_fault_is_not_correct(workload, fault):
    assert not _run(workload, stand_in=fault)['correct']


@pytest.mark.parametrize('workload', CELLS)
def test_the_control_is_not_correct(workload):
    readings = control.readings(workload, [SEED, SEED + 1], 3, device='cpu',
                                overrides=small(workload))
    assert not any(r['correct'] for r in readings)


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_the_control_fails_at_the_cell_size_on_a_card(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the control at the cell size')
    steps = 9 if workload.endswith('map_linear') else 3
    readings = control.readings(workload, [11, 12, 13], steps)
    assert not any(r['correct'] for r in readings)
