"""
Driver ``save_frames``: a night's sequence of one-frame FITS files, one
opened and saved navigated a step. Each step is the user's call
``Observation(path, observer=...).save_observation(out,
include_wireframe=False, print_info=False)`` on the next file of a seeded
order: the file read, the body built from the header's keywords, the disc
from its ``PLANMAP DISC`` cards, the 26 backplanes by their getters, and
the FITS file encoded and written. Every step writes to one output path,
which the next step overwrites, as a user who runs a reduction again does.
The Observation is dropped when the step ends, as in a user's loop, and
Python's cycle collector runs when it would there: the step neither
collects nor freezes objects.

Set-up writes the kernels from the seed, then the configuration's
``files`` input files of one seeded sequence in a run directory under
``TMPDIR``: ``file_spacing_s`` apart from the configuration's ``utc``,
each a ``(1, ny, nx)`` float32 frame (a disc ``mu ** limb_darkening`` plus
``noise`` of seeded unit-normal noise) whose header names the target, the
date (``DATE-OBS``), the telescope, the instrument, the camera, the
filter, and the disc: centred within ``disc_jitter_px`` of the
configuration's (seeded), of its r0 and rotation. The files are written by
the reference's own FITS writer (:mod:`..reference.fits_plain`).

A seeded ``steps_checked`` of the window's steps keep their file: the step
moves it into a slot path with ``os.replace`` (a rename), so the run
directory never holds more than ``steps_checked`` + 2 saved files. After
the window the check reads each kept file and the last step's back with
``fits_plain`` and compares every pixel of the 26 image HDUs with the
reference's planes at the file's own epoch and disc (``plane_gap``,
``mask_flips``), and counts the HDUs of ``PLANE_ORDER`` absent, doubled or
of another shape (``hdus_missing``), the primary values that are not bit
for bit the input frame (``data_changed``), and the largest gap between
the saved ``PLANMAP DISC`` cards and the input file's
(``disc_card_gap``). It removes the run directory.
"""

from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import program
from port_bench.reference import backplanes as rb
from port_bench.reference import compare
from port_bench.reference import fits_plain
from port_bench.reference import scene as rs
from port_bench.vendor.backplanes_plain import PLANE_ORDER
from port_bench.vendor.synthetic_kernels import write_synthetic_kernels

#: File indices drawn ahead of the window (steps past it reuse them)
TABLE = 65536
#: The ``PLANMAP DISC`` cards, in the order of a disc's values
DISC_CARDS = ('X0', 'Y0', 'R0', 'ROT')
DISC_COMMENTS = ('[pixels] x coordinate of disc centre.',
                 '[pixels] y coordinate of disc centre.',
                 '[pixels] equatorial radius of disc.',
                 '[degrees] rotation of image.')


def dates(cfg) -> list[datetime.datetime]:
    """The UTC date of each file of the sequence."""
    start = datetime.datetime.fromisoformat(cfg['utc'])
    step = datetime.timedelta(seconds=cfg['file_spacing_s'])
    return [start + k * step for k in range(cfg['files'])]


def epoch(date: datetime.datetime) -> float:
    """TDB seconds past J2000 of a UTC date."""
    return rs.utc_to_et(date.year, date.month, date.day, date.hour,
                        date.minute, date.second + 1e-6 * date.microsecond)


def _frame(cfg, tr, disc, rng: np.random.Generator) -> np.ndarray:
    nx, ny = cfg['frame']
    x0, y0, r0, _rot = disc
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)
    rr = np.hypot(x - x0, y - y0) / r0
    img = np.sqrt(np.clip(1.0 - rr**2, 0.0, None)) ** tr['limb_darkening']
    img += tr['noise'] * rng.standard_normal(img.shape)
    return img[None].astype(np.float32)


def inputs(ctx) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The files' discs ``(files, 4)`` and frames ``(files, 1, ny, nx)``,
    and the order ``(TABLE,)`` in which the steps open them, drawn from the
    seed."""
    cfg = ctx.config
    x0, y0, r0, rot = cfg['disc']
    rng = program.rng(ctx, program.STREAM_POOL)
    n = cfg['files']
    u = rng.uniform(-1.0, 1.0, (n, 2)) * cfg['disc_jitter_px']
    discs = np.column_stack([x0 + u[:, 0], y0 + u[:, 1], np.full(n, r0),
                             np.full(n, rot)])
    frames = np.stack([_frame(cfg, ctx.traffic, d, rng) for d in discs])
    order = program.rng(ctx, program.STREAM_TRAFFIC).integers(n, size=TABLE)
    return discs, frames, order


def header_cards(cfg, k: int, date, disc) -> list[tuple]:
    """The input file's cards: what the instrument writes that the open
    reads, and the disc a navigation wrote."""
    cards = [('OBJECT', cfg['target'], 'Target name.'),
             ('DATE-OBS', date.strftime('%Y-%m-%dT%H:%M:%S'),
              'UTC date of observation.'),
             ('TELESCOP', cfg['telescope'], None),
             ('INSTRUME', cfg['instrument'], None),
             ('CAMNAME', cfg['camera'], 'Camera.'),
             ('FILTER', cfg['filters'][k % len(cfg['filters'])], None)]
    return cards + [(f'PLANMAP DISC {key}', float(value), comment)
                    for key, value, comment in zip(DISC_CARDS, disc,
                                                   DISC_COMMENTS)]


def setup(ctx):
    cfg, chk = ctx.config, ctx.check
    state = type('State', (), {})()
    state.ctx = ctx
    state.discs, state.frames, state.order = inputs(ctx)
    state.run_dir = tempfile.mkdtemp(prefix='port_bench_frames_')
    atexit.register(shutil.rmtree, state.run_dir, True)
    state.paths = []
    for k, (date, disc, frame) in enumerate(zip(dates(cfg), state.discs,
                                                state.frames)):
        path = os.path.join(state.run_dir, f'frame_{k}.fits')
        fits_plain.write(path, [(header_cards(cfg, k, date, disc), frame)])
        state.paths.append(path)
    state.out = os.path.join(state.run_dir, 'saved.fits')
    state.kept = ctx.Reservoir(chk['steps_checked'],
                               program.rng(ctx, program.STREAM_CHECK))
    state.kept_paths = [os.path.join(state.run_dir, f'kept_{j}.fits')
                        for j in range(state.kept.k)]
    state.kept_files = [None] * state.kept.k
    state.last = None
    state.scene = rs.Scene(ctx.seed)
    state.ets = [epoch(d) for d in dates(cfg)]
    if ctx.stand_in == 'control':
        state.entry = _control_entry(state)
    else:
        import planetmapper_tpu_torch as pt

        write_synthetic_kernels(ctx.kernel_dir, ctx.seed)
        pt.clear_kernels()
        pt.set_kernel_path(ctx.kernel_dir)

        def entry(k, out):
            with record_function('Observation'):
                obs = pt.Observation(state.paths[k],
                                     observer=cfg['observer'],
                                     device=ctx.device)
            with record_function('save_observation'):
                obs.save_observation(out, include_wireframe=False,
                                     print_info=False)

        state.entry = entry if ctx.stand_in is None else ctx.stand_in(entry)
    warmup = 1 if ctx.stand_in == 'control' else ctx.traffic['warmup_steps']
    for i in range(warmup):
        state.entry(int(state.order[-1 - i]), state.out)
    return state


def _control_entry(state):
    """The reference in float32 in the program's place: the input file
    read, the 26 planes at its epoch and disc, written by ``fits_plain``
    after the input's HDU."""
    nx, ny = state.ctx.config['frame']
    anchors = state.scene.anchors(state.ets)

    def entry(k, out):
        primary = fits_plain.read(state.paths[k])[0]
        disc = [primary.get(f'PLANMAP DISC {key}') for key in DISC_CARDS]
        a = {key: v[k] for key, v in anchors.items()}
        m = rs.xy2angular(disc, a['diameter_arcsec'][None])[0]
        planes = rb.planes(a, m, disc, nx, ny, state.ctx.device,
                           dtype=torch.float32)
        fits_plain.write(out, [(primary.cards, primary.data)] + [
            ([('EXTNAME', name, None)], planes[name]) for name in PLANE_ORDER])

    return entry


def step(state, i):
    k = int(state.order[i % TABLE])
    state.entry(k, state.out)
    path = state.out
    slot = state.kept.offer(i)
    if slot is not None:
        path = state.kept_paths[slot]
        os.replace(state.out, path)
        state.kept_files[slot] = k
    state.last = (k, path)


def release(state):
    state.entry = None


def _disc_card_gap(primary, disc) -> float:
    gaps = []
    for key, value in zip(DISC_CARDS, disc):
        saved = primary.get(f'PLANMAP DISC {key}')
        ok = isinstance(saved, (int, float)) and not isinstance(saved, bool)
        gaps.append(abs(float(saved) - float(value)) if ok else np.inf)
    return max(gaps)


def _data_changed(primary, frame: np.ndarray) -> int:
    data = primary.data
    if data is None or data.dtype != frame.dtype or data.shape != frame.shape:
        return frame.size
    return int(np.count_nonzero(data.view(np.uint32) != frame.view(np.uint32)))


def _planes(hdus, ny: int, nx: int) -> tuple[dict, int]:
    """The image HDUs of ``PLANE_ORDER`` by ``EXTNAME`` (float64), and the
    count of names absent, doubled or of another shape."""
    got, missing = {}, 0
    for name in PLANE_ORDER:
        found = [h for h in hdus[1:] if h.name == name]
        if len(found) != 1 or found[0].data is None or \
                found[0].data.shape != (ny, nx):
            missing += 1
        else:
            got[name] = found[0].data.astype(np.float64)
    return got, missing


def check(state):
    ctx = state.ctx
    nx, ny = ctx.config['frame']
    try:
        anchors = state.scene.anchors(state.ets)
        compared = [(state.kept_files[j], state.kept_paths[j])
                    for j in state.kept.filled()]
        if state.last[1] not in {path for _, path in compared}:
            compared.insert(0, state.last)
        gap, flips, missing, changed, card_gap = 0.0, 0, 0, 0, 0.0
        worst = {}
        for k, path in compared:
            hdus = fits_plain.read(path)
            disc = state.discs[k]
            changed += _data_changed(hdus[0], state.frames[k])
            card_gap = max(card_gap, _disc_card_gap(hdus[0], disc))
            got, absent = _planes(hdus, ny, nx)
            missing += absent
            del hdus
            a = {key: v[k] for key, v in anchors.items()}
            m = rs.xy2angular(disc, a['diameter_arcsec'][None])[0]
            ref = rb.planes(a, m, disc, nx, ny, ctx.device)
            # a plane that is not there counts in hdus_missing alone
            got = {name: got.get(name, r) for name, r in ref.items()}
            g, f, each = compare.planes(got, ref, rs.RADII[0])
            gap, flips = max(gap, g), flips + f
            worst = {key: max(v, worst.get(key, 0.0))
                     for key, v in each.items()}
            del got, ref
    finally:
        shutil.rmtree(state.run_dir, ignore_errors=True)
    state.notes = [f'{len(compared)} files compared'] + [
        f'plane_gap of {key}: {v!r}' for key, v in
        sorted(worst.items(), key=lambda kv: -kv[1])[:6]]
    return dict(plane_gap=gap, mask_flips=flips, hdus_missing=missing,
                data_changed=changed, disc_card_gap=card_gap)


def work(state):
    """No kernel of this path has a roofline reader. A step copies its 26
    float64 planes to the host (``d2h_rate``'s count where the profiler
    records no bytes)."""
    nx, ny = state.ctx.config['frame']
    return {'d2h_bytes_per_step': nx * ny * len(PLANE_ORDER) * 8}
