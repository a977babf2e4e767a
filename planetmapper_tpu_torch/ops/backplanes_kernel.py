"""
The 26-backplane CUDA kernel (``csrc/backplanes.cu``) and its wrapper.

Replaces the TPU kernel ``planetmapper_tpu/ops/pallas_pipeline.py:
build_pallas_pipeline`` with a hand-written kernel for Hopper (sm_90a). The
source note in ``csrc/backplanes.cu`` says what bounds it, how it is laid
out and the precision of each plane. Here:

- :data:`LIBRARY` (:mod:`.cuda_build`) compiles the source with ``nvcc``
  into a shared library with a plain C interface under ``build/`` and loads
  it with ``ctypes``, at first use on a CUDA device, never at import.
- :func:`pack_scenes` reduces the scenes of N frames (each frame's
  ``xy2angular`` matrix and disc parameters, the radii and the anchors) to
  the kernel's 106 float64 values a frame with numpy on the host. A scene
  is a shared part, from the radii and the anchors, and a frame part; the
  last packing is kept (:data:`_last_packed`), so that a call on a body's
  cached anchors packs only its frame parts.
- :func:`build_backplanes_kernel` returns an ``impl`` whose one call,
  ``impl.frames(nx, ny, xy2angulars, discs, radii, anchors, *, device,
  row0=0.0)``, packs the scenes and launches the kernel on the current
  stream, counting each launch; a build or launch fault raises.
  The single-frame kernel takes its scene by value in its launch
  parameters, so a launch copies no scene buffer and runs no preparatory
  kernel. One frame is one launch of it; N frames are the launches of
  :func:`batch_plan` of the batched kernel (:func:`batch_launch_count`) in
  32x8 tiles or linear blocks by the frame's width, or, for frames of
  :data:`FRAME_LAUNCH_PIXELS` or more (:func:`frame_route`), one launch of
  the single-frame kernel a frame from one C call. RADIAL-VELOCITY is
  stored by the kernel in float64 (the contract's type), the other planes
  in float32. Its plain version, with the same call, is
  :func:`..pipeline.fused_backplanes_fn` (at ``precision='mixed'``, the
  kernel's LON-CENTRIC range).
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..core.ephemeris import CLIGHT
from ..pipeline import ANCHOR_SHAPES as _ANCHOR_SHAPES
from ..pipeline import frame_inputs
from .cuda_build import CudaLibrary, check_launch

DEG = math.pi / 180.0

#: Output plane order of the kernel's stacked (NP, ny, nx) result.
PLANE_ORDER = (
    'LON-GRAPHIC', 'LAT-GRAPHIC', 'LON-CENTRIC', 'LAT-CENTRIC',
    'RA', 'DEC', 'PIXEL-X', 'PIXEL-Y', 'KM-X', 'KM-Y',
    'ANGULAR-X', 'ANGULAR-Y', 'PHASE', 'INCIDENCE', 'EMISSION',
    'AZIMUTH', 'LOCAL-SOLAR-TIME', 'DISTANCE', 'RADIAL-VELOCITY',
    'DOPPLER', 'LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC',
    'RING-RADIUS', 'RING-LON-GRAPHIC', 'RING-DISTANCE',
)

#: Planes that are NaN wherever the ray misses the disc (with
#: optimize_speed the kernel skips their chain outside the r_cut circle).
DISC_PLANES = (
    'LON-GRAPHIC', 'LAT-GRAPHIC', 'LON-CENTRIC', 'LAT-CENTRIC',
    'PHASE', 'INCIDENCE', 'EMISSION', 'AZIMUTH',
    'LOCAL-SOLAR-TIME', 'DISTANCE', 'RADIAL-VELOCITY', 'DOPPLER',
)

#: Layout of the float64 scene (the ``Scene`` offsets of the source).
_SCENE_LAYOUT = (
    ('ray', 6), ('m_ang', 9), ('km', 6), ('angular', 6),
    ('et_tau0', 1), ('tau0', 1), ('target_lt', 1),
    ('targ_rel0', 3), ('targ_vel0', 3),
    ('rot0', 9), ('rot1', 9), ('rot2h', 9),
    ('rinv', 3), ('rinv2', 3),
    ('re', 1), ('omf', 1), ('omf2', 1), ('e2', 1), ('ep2_re_omf', 1),
    ('e2_re', 1), ('disc', 3),
    ('sun_rel0', 3), ('sun_vel0', 3), ('sun_off', 1), ('obs_vel', 3),
    ('solar_lon_e', 1),
    ('target_obsvec', 3), ('subpoint_obsvec', 3), ('subpoint_rayvec', 3),
    ('subpoint_distance', 1), ('subpoint_targvec', 3),
    ('ring_plane_normal', 3), ('ring_plane_constant', 1),
)
SCENE_SIZE = sum(n for _, n in _SCENE_LAYOUT)
#: Each value's (first word, words) in a scene.
_SLOTS = {name: (sum(n for _, n in _SCENE_LAYOUT[:i]), size)
          for i, (name, size) in enumerate(_SCENE_LAYOUT)}

_F_POSITIVE_WEST = 1
_F_PROGRADE = 2
_F_HAVE_SUN = 4
_F_OPTIMIZE_SPEED = 8
_F_LST_QUANT = 16

#: Light-time updates before the final intercept.
LT_ITERS = 2


def _configure(lib) -> None:
    lib.backplanes26_scene_size.restype = ctypes.c_int
    lib.backplanes26_n_planes.restype = ctypes.c_int
    lib.backplanes26_launch.restype = ctypes.c_int
    lib.backplanes26_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scene, outputs
        ctypes.c_int, ctypes.c_int, ctypes.c_double,  # nx, ny, row0
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,  # slots, iterations, flags, stream
    ]
    lib.backplanes26_launch_frames.restype = ctypes.c_int
    lib.backplanes26_launch_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scenes, outs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nx, ny, frames
        ctypes.c_double, ctypes.POINTER(ctypes.c_int),  # row0, slots
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # iterations, flags
        ctypes.c_void_p,  # stream
    ]
    for name, extra in (('backplanes26_launch_batch', [ctypes.c_int]),
                        ('backplanes26_launch_batch_tiles', [])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scenes, outs
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,  # nx, ny, frames
            ctypes.c_longlong, ctypes.c_int,  # first, count
            *extra,  # threads (linear blocks)
            ctypes.c_double, ctypes.POINTER(ctypes.c_int),  # row0, slots
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # iterations, flags
            ctypes.c_void_p,  # stream
        ]
    lib.backplanes26_batch_threads.restype = ctypes.c_int
    lib.backplanes26_block_scenes.restype = ctypes.c_int
    lib.backplanes26_occupancy.restype = ctypes.c_int
    lib.backplanes26_occupancy.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    if lib.backplanes26_scene_size() != SCENE_SIZE:
        raise RuntimeError(
            f'backplanes.cu expects {lib.backplanes26_scene_size()} scene '
            f'scalars, the wrapper packs {SCENE_SIZE}'
        )
    if lib.backplanes26_n_planes() != len(PLANE_ORDER):
        raise RuntimeError('plane count of the kernel and wrapper differ')
    if (lib.backplanes26_batch_threads(), lib.backplanes26_block_scenes()) \
            != (BATCH_THREADS, BLOCK_SCENES):
        raise RuntimeError('the batched launches of the kernel and wrapper '
                           'differ')


LIBRARY = CudaLibrary('backplanes26', 'backplanes.cu', _configure)
load_library = LIBRARY.load
launch_count = LIBRARY.launch_count
reset_launch_count = LIBRARY.reset_launch_count
ptxas_log = LIBRARY.ptxas_log


#: The counter of the batched kernel's launches (the library's own is the
#: single-frame kernel's).
BATCH_COUNTER = f'{LIBRARY.counter}_batch'

#: Frames of this many pixels or more take one launch of the single-frame
#: kernel each in a batch (``impl.frames``): its scene is constant-bank
#: operands, while the batched kernel's scene reads cost it 1.04x per frame
#: at 768x768 and 1.13x at 2048x2048; it saves 0.4% at 640x640, 9% at
#: 512x512 and 36% at 256x256, where launches dominate
#: (scripts/time_backplane_batch.py on an H100 80GB HBM3 at 700 W, 8
#: frames, the batched kernel in tiles).
FRAME_LAUNCH_PIXELS = 768 * 768


#: Threads of a batched block at most (``kBatchThreads`` of the source).
BATCH_THREADS = 256
#: The single-frame kernel's tiles (columns, rows).
TILE = (32, 8)
#: Frames of at least TILE_PIXELS pixels whose tiles fill this share of
#: their lanes or more take the tiles and their shared ray tables in a
#: batch, the scenes in the launch's parameters
#: (``backplanes26_batch_tiles_kernel``); others linear blocks, a ray per
#: pixel, the scenes read from the card (``backplanes26_batch_kernel``).
#: On an H100 (scripts/time_backplane_batch.py, 8 frames) the tiles won at
#: 100% (256^2: 13%) and 89% (200^2: 4%), the linear blocks at 75%
#: (100^2: 4%).
TILE_FILL = 0.85
#: A tiled launch carries 38 frames: smaller ones take linear blocks, one
#: launch for them all.
TILE_PIXELS = 128 * 128
#: Frames of one tiled launch at most: their scenes fill its parameters
#: (``kBlockScenes`` of the source).
BLOCK_SCENES = 38
#: Blocks of one launch in linear blocks at most (the grid's x limit).
MAX_GRID_X = 2**31 - 1


class BatchPlan(NamedTuple):
    """The batched kernel's launches: ``tiles`` (32x8 tiles, else linear
    blocks of ``threads`` pixels), blocks over one frame, and ``launches``
    as ``[(first frame, frames), ...]``."""

    tiles: bool
    threads: int
    blocks_per_frame: int
    launches: list


def batch_plan(n_frames: int, nx: int, ny: int,
               frames_per_launch: int | None = None) -> BatchPlan:
    """
    The batched kernel's launches for ``n_frames`` frames of ``nx`` x
    ``ny``. Frames of :data:`TILE_PIXELS` or more whose :data:`TILE`
    tiles fill :data:`TILE_FILL` of their lanes take the tiles, a frame a
    grid layer; others linear blocks:
    a block takes ``threads`` consecutive pixels of one frame in row-major
    order (:data:`BATCH_THREADS`, or the frame's pixels rounded up to a
    warp when fewer), the frame's last block the rest. A launch takes at
    most ``frames_per_launch`` frames (a candidate's chunk, for timing and
    tests), in tiles :data:`BLOCK_SCENES`, in linear blocks as many as the
    grid holds.
    """
    frame_size = nx * ny
    if n_frames < 1 or nx < 1 or ny < 1 or frame_size >= 2**31:
        raise ValueError(f'no batched launch for {n_frames} frames of '
                         f'{nx}x{ny}')
    tiles_x, tiles_y = -(-nx // TILE[0]), -(-ny // TILE[1])
    tiles = frame_size >= max(
        TILE_PIXELS, TILE_FILL * (tiles_x * tiles_y * BATCH_THREADS))
    if tiles:
        threads, blocks_per_frame = BATCH_THREADS, tiles_x * tiles_y
        per_launch = BLOCK_SCENES
    else:
        threads = min(BATCH_THREADS, -(-frame_size // 32) * 32)
        blocks_per_frame = -(-frame_size // threads)
        per_launch = MAX_GRID_X // blocks_per_frame
    if frames_per_launch:
        per_launch = min(per_launch, frames_per_launch)
    launches = [(first, min(per_launch, n_frames - first))
                for first in range(0, n_frames, per_launch)]
    return BatchPlan(tiles, threads, blocks_per_frame, launches)


def frame_route(nx: int, ny: int) -> bool:
    """Whether a batch of ``nx`` x ``ny`` frames takes one single-frame
    launch a frame (:data:`FRAME_LAUNCH_PIXELS` or more pixels) rather than
    the batched kernel."""
    return nx * ny >= FRAME_LAUNCH_PIXELS


def batch_launch_count() -> int:
    """Launches of the batched kernel so far in this process."""
    return tracing.counts().get(BATCH_COUNTER, 0)


def reset_batch_launch_count() -> None:
    tracing.reset(BATCH_COUNTER)


def occupancy(batch: str | None = None) -> dict[str, int]:
    """
    ``dict(registers, local_bytes, blocks_per_sm)`` of the compiled
    single-frame kernel (``batch='linear'`` or ``'tiles'``: the batched one
    in that layout) on the current CUDA device: registers and local (spill)
    bytes per thread, and resident blocks of 256 threads per SM.
    """
    lib = load_library()
    values = [ctypes.c_int() for _ in range(3)]
    which = {None: 0, 'linear': 1, 'tiles': 2}[batch]
    check_launch(lib.backplanes26_occupancy(which, *values),
                 'backplane occupancy')
    return dict(zip(('registers', 'local_bytes', 'blocks_per_sm'),
                    (v.value for v in values)))


def _frame_parts(a, disc, radii, angular2km, target_lt) -> dict:
    """
    The frame-dependent scene values from ``xy2angular`` matrices ``a``
    (..., 3, 3), discs (..., 4) and the radii and anchors they combine
    with: one frame, or N along a leading axis.
    """
    re = radii[..., 0]
    # ray angles in half turns (the kernel's sincospi), affine in (x, y):
    # the plain graph's -ang_x / 3600 * DEG and ang_y / 3600 * DEG over pi
    ray = np.concatenate([-a[..., 0, :], a[..., 1, :]], axis=-1) * (
        DEG / 3600.0 / math.pi)
    # angular2km @ a[:2], summed in index order
    km = (angular2km[..., :, 0, None] * a[..., None, 0, :]
          + angular2km[..., :, 1, None] * a[..., None, 1, :])
    km_per_arcsec = 2.0 * re / (
        2.0 * 60.0 * 60.0 / DEG * np.arcsin(re / (target_lt * CLIGHT))
    )
    r_cut = disc[..., 2] * np.max(radii, axis=-1) / re * 1.05 + 1.0
    return dict(
        ray=ray,
        km=km,
        angular=km / np.asarray(km_per_arcsec)[..., None, None],
        disc=np.stack([disc[..., 0], disc[..., 1], r_cut * r_cut], axis=-1),
    )


def _scene_parts(radii, v) -> dict:
    """The scene values of N frames that depend on the radii and anchors."""
    re, rp = radii[..., 0], radii[..., 2]
    flattening = (re - rp) / re
    omf = 1.0 - flattening
    e2 = flattening * (2.0 - flattening)
    ep2 = e2 / (1.0 - e2)
    return dict(
        m_ang=v['obsvec2angular'],
        et_tau0=v['et'] - v['tau0'],
        tau0=v['tau0'],
        target_lt=v['target_lt'],
        targ_rel0=v['targ_pos0'] - v['obs_pos'],
        targ_vel0=v['targ_vel0'],
        rot0=v['rot0'],
        rot1=v['rot1'],
        rot2h=0.5 * v['rot2'],
        rinv=1.0 / radii,
        rinv2=1.0 / (radii * radii),
        re=re,
        omf=omf,
        omf2=omf * omf,
        e2=e2,
        ep2_re_omf=ep2 * (re * omf),
        e2_re=e2 * re,
        sun_rel0=v['sun_pos0'] - v['targ_pos0'],
        sun_vel0=v['sun_vel0'],
        sun_off=v['et'] - v['sun_epoch0'],
        obs_vel=v['obs_vel'],
        solar_lon_e=v['solar_lon_e'],
        target_obsvec=v['target_obsvec'],
        subpoint_obsvec=v['subpoint_obsvec'],
        subpoint_rayvec=v['subpoint_rayvec'],
        subpoint_distance=v['subpoint_distance'],
        subpoint_targvec=v['subpoint_targvec'],
        ring_plane_normal=v['ring_plane_normal'],
        ring_plane_constant=v['ring_plane_constant'],
    )


def _fill(scenes: np.ndarray, parts: dict) -> None:
    """Write ``parts`` (each one value, or N along a leading axis) into
    their slots of ``scenes``."""
    n = scenes.shape[0]
    for name, value in parts.items():
        start, size = _SLOTS[name]
        value = np.asarray(value, dtype=np.float64)
        if value.size not in (size, n * size):
            raise ValueError(f'scene value {name!r} has {value.size} '
                             f'elements, expected {size} a frame')
        scenes[:, start:start + size] = value.reshape(-1, size)


def _values(n: int, values: dict) -> dict:
    """Each anchor (or radii) value as float64, shared (its own shape) or
    per frame (a leading axis of ``n``)."""
    shapes = dict(_ANCHOR_SHAPES, radii=(3,))
    out = {}
    for key, shape in shapes.items():
        value = np.asarray(values[key], dtype=np.float64)
        if value.shape not in (shape, (n,) + shape):
            raise ValueError(f'{key} has shape {value.shape}, expected '
                             f'{shape} or {(n,) + shape}')
        out[key] = value
    if not np.all(np.abs(out['solar_lon_e']) <= math.pi):
        raise ValueError('solar_lon_e must lie in [-pi, pi]')
    return out


def pack_scenes(xy2angulars, discs, radii, anchors,
                shared=None) -> np.ndarray:
    """
    The kernel's float64 scenes of N >= 1 frames, (N, :data:`SCENE_SIZE`),
    in the order of ``_SCENE_LAYOUT``, computed with numpy on the host:
    ``xy2angulars`` (N, 3, 3) and ``discs`` (N, 4) per frame; ``radii``
    (3,) and each anchor either shared (its own shape) or per frame (a
    leading axis of N).

    A scene is a shared part, from the radii and the anchors, and a frame
    part, from the frame's affine and disc. ``shared``, a scene packed
    earlier from these radii and shared anchors (any one row of this
    function's result), stands for the shared part: it is repeated and
    only the frame parts are written in, word for word what packing both
    parts gives (each step is elementwise over the frame axis).
    """
    a, disc = frame_inputs(xy2angulars, discs)
    n = len(a)
    if shared is None:
        v = _values(n, dict(anchors, radii=radii))
        scenes = np.empty((n, SCENE_SIZE), dtype=np.float64)
        parts = _scene_parts(v['radii'], v)
    else:
        scenes = np.repeat(
            np.asarray(shared, dtype=np.float64).reshape(1, SCENE_SIZE), n,
            axis=0)
        v = dict(radii=np.asarray(radii, dtype=np.float64),
                 angular2km=np.asarray(anchors['angular2km'],
                                       dtype=np.float64),
                 target_lt=np.asarray(anchors['target_lt'],
                                      dtype=np.float64))
        parts = {}
    parts.update(_frame_parts(a, disc, v['radii'], v['angular2km'],
                              v['target_lt']))
    _fill(scenes, parts)
    return scenes


#: The last packing over anchors that every frame shares: ``(anchors,
#: radii, frame, scene)``, the radii as bytes, ``frame`` the bytes of a lone
#: frame's affine and disc (None for a batch) and ``scene`` its first
#: scene, (1, :data:`SCENE_SIZE`). A body's anchors are one cached dict, so
#: a call on the same dict and radii packs only its frame parts, and a lone
#: frame packed last time (the blocks of a sharded call) packs nothing. This
#: holds because no anchors dict is edited in place: new anchors are a new
#: dict.
_last_packed = None


def _scenes(xy2angulars, discs, radii, anchors) -> np.ndarray:
    """:func:`pack_scenes`, over the last call's shared part or scene
    where they serve (:data:`_last_packed`)."""
    global _last_packed
    a, disc = frame_inputs(xy2angulars, discs)
    radii = np.asarray(radii, dtype=np.float64)
    key = radii.tobytes()
    frame = a.tobytes() + disc.tobytes() if len(a) == 1 else None
    last = _last_packed
    if last is not None and last[0] is anchors and last[1] == key:
        if frame is not None and last[2] == frame:
            return last[3]
        scenes = pack_scenes(a, disc, radii, anchors, shared=last[3][0])
    else:
        scenes = pack_scenes(a, disc, radii, anchors)
        if any(np.shape(anchors[k]) != shape
               for k, shape in _ANCHOR_SHAPES.items()):
            return scenes  # per-frame anchors are not kept
    _last_packed = (anchors, key, frame,
                    scenes if frame is not None else scenes[:1].copy())
    return scenes


def build_backplanes_kernel(
    *,
    positive_west: bool,
    prograde: bool,
    have_sun: bool,
    optimize_speed: bool,
    lst_quant: bool,
    planes: tuple[str, ...] | None = None,
    geodetic_iters: int = 0,
):
    """
    Build the kernel's ``impl``, whose ``impl.frames`` computes the 26
    planes (or the ``planes`` subset) of N frames on a CUDA device.
    :data:`LT_ITERS` light-time updates precede the final intercept;
    ``geodetic_iters`` is the Bowring refinement count of the graphic
    latitudes (0 biaxial, 4 triaxial).
    """
    if planes is not None and set(planes) - set(PLANE_ORDER):
        raise ValueError(
            f'unknown planes: {sorted(set(planes) - set(PLANE_ORDER))}'
        )
    requested = (
        PLANE_ORDER if planes is None
        else tuple(n for n in PLANE_ORDER if n in planes)
    )
    # RADIAL-VELOCITY is stored in float64 into its own buffer; the other
    # requested planes are the float32 stack, in PLANE_ORDER
    stacked_names = tuple(n for n in requested if n != 'RADIAL-VELOCITY')
    slot_of = {name: i for i, name in enumerate(stacked_names)}
    if 'RADIAL-VELOCITY' in requested:
        slot_of['RADIAL-VELOCITY'] = 0
    flags = (
        (_F_POSITIVE_WEST if positive_west else 0)
        | (_F_PROGRADE if prograde else 0)
        | (_F_HAVE_SUN if have_sun else 0)
        | (_F_OPTIMIZE_SPEED if optimize_speed else 0)
        | (_F_LST_QUANT if lst_quant else 0)
    )
    slots = (ctypes.c_int * len(PLANE_ORDER))(
        *[slot_of.get(name, -1) for name in PLANE_ORDER]
    )
    consts = (slots, LT_ITERS, int(geodetic_iters), flags)

    def frames(nx, ny, xy2angulars, discs, radii, anchors, *, device,
               row0=0.0, frame_launches=None):
        """
        The requested planes of N >= 1 frames, each (N, ny, nx), on the
        CUDA ``device``, from host float64 values as :func:`pack_scenes`
        takes them. Each plane is a contiguous view of one (NP, N, ny, nx)
        float32 allocation; RADIAL-VELOCITY has its own (N, ny, nx) float64
        one.

        One frame is one launch of the single-frame kernel (counted by
        :func:`launch_count`). Frames of :data:`FRAME_LAUNCH_PIXELS` or
        more are N launches of it from one C call, each with its scene by
        value, because there the batched kernel's scene reads cost more
        than a launch; smaller ones take the launches of :func:`batch_plan`
        of the batched kernel (each counted by :func:`batch_launch_count`).
        ``frame_launches`` forces one route (for tests and timing).
        """
        with tracing.span('pm.scene.pack'):
            scenes = _scenes(xy2angulars, discs, radii, anchors)
        return launch(scenes, nx, ny, device=device, row0=row0,
                      frame_launches=frame_launches)

    def launch(scenes, nx, ny, *, device, row0=0.0, frame_launches=None):
        """:func:`frames`' launches on scenes that :func:`pack_scenes`
        packed: host numpy, or for the batched kernel's linear blocks a
        tensor on ``device`` too (to time the kernel alone)."""
        device = torch.device(device)
        if device.type != 'cuda':
            raise ValueError(f'no backplane kernel for device {device}')
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        if nx <= 0 or ny <= 0:
            raise ValueError(f'image size must be positive, got {nx}x{ny}')
        nx, ny, row0 = int(nx), int(ny), float(row0)
        n = len(scenes)
        if frame_launches is None:
            frame_launches = n == 1 or frame_route(nx, ny)
        plan = None if frame_launches else batch_plan(n, nx, ny)
        with tracing.span('pm.kernel1.launch'):
            stacked = torch.empty((len(stacked_names), n, ny, nx),
                                  dtype=torch.float32, device=device)
            rv = None
            if 'RADIAL-VELOCITY' in requested:
                rv = torch.empty((n, ny, nx), dtype=torch.float64,
                                 device=device)
            outs = (stacked.data_ptr(), None if rv is None else rv.data_ptr())
            lib = load_library()
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                if frame_launches and n == 1:
                    rc = lib.backplanes26_launch(scenes.ctypes.data, *outs,
                                                 nx, ny, row0, *consts,
                                                 stream)
                    check_launch(rc, 'backplane')
                    LIBRARY.count_launches()
                elif frame_launches:
                    rc = lib.backplanes26_launch_frames(
                        scenes.ctypes.data, *outs, nx, ny, n, row0, *consts,
                        stream)
                    check_launch(rc, 'batched backplane')
                    LIBRARY.count_launches(n)
                else:
                    if not plan.tiles:
                        # linear blocks read their scenes from the card
                        on_card = scenes if isinstance(
                            scenes, torch.Tensor) else torch.from_numpy(
                                scenes).to(device, non_blocking=True)
                    for first, count in plan.launches:
                        if plan.tiles:
                            rc = lib.backplanes26_launch_batch_tiles(
                                scenes.ctypes.data, *outs, nx, ny, n, first,
                                count, row0, *consts, stream)
                        else:
                            rc = lib.backplanes26_launch_batch(
                                on_card.data_ptr(), *outs, nx, ny, n, first,
                                count, plan.threads, row0, *consts, stream)
                        check_launch(rc, 'batched backplane')
                        tracing.count(BATCH_COUNTER)
        planes = dict(zip(stacked_names, stacked))
        planes['RADIAL-VELOCITY'] = rv
        return {name: planes[name] for name in requested}

    return SimpleNamespace(frames=frames, _launch=launch)
