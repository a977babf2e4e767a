"""
The 26-backplane CUDA kernel (``csrc/backplanes.cu``) and its wrapper.

Replaces the TPU kernel ``planetmapper_tpu/ops/pallas_pipeline.py:
build_pallas_pipeline`` with a hand-written kernel for Hopper (sm_90a). The
source note in ``csrc/backplanes.cu`` says what bounds it and how it is laid
out. Here:

- :data:`LIBRARY` (:mod:`.cuda_build`) compiles the source with ``nvcc``
  into a shared library with a plain C interface under ``build/`` and loads
  it with ``ctypes``, at first use on a CUDA device, never at import.
- :func:`build_backplanes_kernel` returns ``impl(nx, ny, xy2angular, disc,
  radii, anchors, row0=0.0) -> dict`` with the contract of the JAX
  package's kernel. On CUDA tensors it computes the per-scene float64
  scalars with PyTorch on the device, launches the kernel on the current
  stream and counts the launch; a build or launch fault raises. Only CPU
  tensors take the plain version, :func:`..pipeline.fused_backplanes_fn`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.ephemeris import CLIGHT
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

#: Layout of the float64 scene vector (the ``Scene`` offsets of the source).
_SCENE_LAYOUT = (
    ('xy2a', 6), ('m_ang', 9), ('et', 1), ('tau0', 1), ('target_lt', 1),
    ('targ_rel0', 3), ('targ_vel0', 3), ('targ_pos0', 3),
    ('rot0', 9), ('rot1', 9), ('rot2h', 9),
    ('radii', 3), ('flattening', 1), ('disc', 3),
    ('sun_pos0', 3), ('sun_vel0', 3), ('sun_epoch0', 1), ('obs_vel', 3),
    ('angular2km', 4), ('km_per_arcsec', 1), ('solar_lon_e', 1),
    ('target_obsvec', 3), ('subpoint_obsvec', 3), ('subpoint_rayvec', 3),
    ('subpoint_distance', 1), ('subpoint_targvec', 3),
    ('ring_plane_normal', 3), ('ring_plane_constant', 1),
)
SCENE_SIZE = sum(n for _, n in _SCENE_LAYOUT)

_F_POSITIVE_WEST = 1
_F_PROGRADE = 2
_F_HAVE_SUN = 4
_F_OPTIMIZE_SPEED = 8
_F_LST_QUANT = 16

def _configure(lib) -> None:
    lib.backplanes26_scene_size.restype = ctypes.c_int
    lib.backplanes26_n_planes.restype = ctypes.c_int
    lib.backplanes26_launch.restype = ctypes.c_int
    lib.backplanes26_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    if lib.backplanes26_scene_size() != SCENE_SIZE:
        raise RuntimeError(
            f'backplanes.cu expects {lib.backplanes26_scene_size()} scene '
            f'scalars, the wrapper packs {SCENE_SIZE}'
        )
    if lib.backplanes26_n_planes() != len(PLANE_ORDER):
        raise RuntimeError('plane count of the kernel and wrapper differ')


LIBRARY = CudaLibrary('backplanes26', 'backplanes.cu', _configure)
load_library = LIBRARY.load
launch_count = LIBRARY.launch_count
reset_launch_count = LIBRARY.reset_launch_count
ptxas_log = LIBRARY.ptxas_log


def scene_scalars(xy2angular, disc, radii, anchors) -> torch.Tensor:
    """
    The float64 scene vector the kernel reads, computed with PyTorch on the
    inputs' device in the order of ``_SCENE_LAYOUT``.
    """
    re = radii[0]
    parts = dict(
        xy2a=xy2angular[:2],
        m_ang=anchors['obsvec2angular'],
        et=anchors['et'],
        tau0=anchors['tau0'],
        target_lt=anchors['target_lt'],
        targ_rel0=anchors['targ_pos0'] - anchors['obs_pos'],
        targ_vel0=anchors['targ_vel0'],
        targ_pos0=anchors['targ_pos0'],
        rot0=anchors['rot0'],
        rot1=anchors['rot1'],
        rot2h=0.5 * anchors['rot2'],
        radii=radii,
        flattening=(re - radii[2]) / re,
        disc=torch.stack([
            disc[0], disc[1], disc[2] * torch.max(radii) / re * 1.05 + 1.0,
        ]),
        sun_pos0=anchors['sun_pos0'],
        sun_vel0=anchors['sun_vel0'],
        sun_epoch0=anchors['sun_epoch0'],
        obs_vel=anchors['obs_vel'],
        angular2km=anchors['angular2km'],
        km_per_arcsec=2.0 * re / (
            2.0 * 60.0 * 60.0 / DEG * torch.asin(
                re / (anchors['target_lt'] * CLIGHT)
            )
        ),
        solar_lon_e=anchors['solar_lon_e'],
        target_obsvec=anchors['target_obsvec'],
        subpoint_obsvec=anchors['subpoint_obsvec'],
        subpoint_rayvec=anchors['subpoint_rayvec'],
        subpoint_distance=anchors['subpoint_distance'],
        subpoint_targvec=anchors['subpoint_targvec'],
        ring_plane_normal=anchors['ring_plane_normal'],
        ring_plane_constant=anchors['ring_plane_constant'],
    )
    flat = []
    for name, size in _SCENE_LAYOUT:
        value = parts[name].reshape(-1)
        if value.numel() != size:
            raise ValueError(f'scene value {name!r} has {value.numel()} '
                             f'elements, expected {size}')
        flat.append(value)
    return torch.cat(flat).contiguous()


def _check_inputs(xy2angular, disc, radii, anchors) -> torch.device:
    device = radii.device
    named = dict(xy2angular=xy2angular, disc=disc, radii=radii)
    named.update({f'anchors[{k!r}]': v for k, v in anchors.items()})
    shapes = dict(xy2angular=(3, 3), disc=(4,), radii=(3,))
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name} must be a torch.Tensor')
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, radii on {device}')
        if t.dtype != torch.float64:
            raise TypeError(f'{name} must be float64, got {t.dtype}')
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f'{name} must have shape {shapes[name]}')
    return device


def build_backplanes_kernel(
    *,
    positive_west: bool,
    prograde: bool,
    have_sun: bool,
    optimize_speed: bool,
    lst_quant: bool,
    n_lt_iters: int = 2,
    planes: tuple[str, ...] | None = None,
    geodetic_iters: int = 0,
):
    """
    Build ``impl(nx, ny, xy2angular, disc, radii, anchors, row0=0.0) ->
    dict`` computing the 26 planes (or the ``planes`` subset) in one kernel
    launch on CUDA tensors. ``n_lt_iters`` light-time updates precede the
    final intercept; ``geodetic_iters`` is the Bowring refinement count of
    the graphic latitudes (0 biaxial, 4 triaxial).
    """
    if planes is not None and set(planes) - set(PLANE_ORDER):
        raise ValueError(
            f'unknown planes: {sorted(set(planes) - set(PLANE_ORDER))}'
        )
    requested = (
        PLANE_ORDER if planes is None
        else tuple(n for n in PLANE_ORDER if n in planes)
    )
    slot_of = {name: i for i, name in enumerate(requested)}
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

    def launch(scene, stacked, nx, ny, row0=0.0):
        """
        Launch on prepared CUDA buffers: the float64 scene vector of
        :func:`scene_scalars` and the float32 ``(NP, ny, nx)`` output.
        """
        if scene.numel() != SCENE_SIZE or not scene.is_contiguous():
            raise ValueError(f'scene must hold {SCENE_SIZE} contiguous values')
        if scene.dtype != torch.float64 or stacked.dtype != torch.float32:
            raise TypeError('scene must be float64 and the output float32')
        if (
            tuple(stacked.shape) != (len(requested), ny, nx)
            or not stacked.is_contiguous()
        ):
            raise ValueError(
                f'output must be a contiguous ({len(requested)}, {ny}, {nx}) '
                'tensor'
            )
        if scene.device != stacked.device or stacked.device.type != 'cuda':
            raise ValueError('scene and output must be on one CUDA device')
        lib = load_library()
        with torch.cuda.device(stacked.device):
            stream = torch.cuda.current_stream(stacked.device).cuda_stream
            rc = lib.backplanes26_launch(
                scene.data_ptr(), stacked.data_ptr(), int(nx), int(ny),
                float(row0), slots, int(n_lt_iters), int(geodetic_iters),
                flags, stream,
            )
        check_launch(rc, 'backplane')
        LIBRARY.launches += 1

    def impl(nx, ny, xy2angular, disc, radii, anchors, row0=0.0):
        device = _check_inputs(xy2angular, disc, radii, anchors)
        if device.type == 'cpu':
            from ..pipeline import fused_backplanes_fn

            plain = fused_backplanes_fn(
                positive_west=positive_west, prograde=prograde,
                have_sun=have_sun, optimize_speed=optimize_speed,
                robust_geodetic=geodetic_iters > 0,
            )
            out = plain(nx, ny, xy2angular, disc, radii, anchors, row0=row0)
            return {name: out[name] for name in requested}
        if device.type != 'cuda':
            raise ValueError(f'no backplane kernel for device {device}')
        if nx <= 0 or ny <= 0:
            raise ValueError(f'image size must be positive, got {nx}x{ny}')

        scene = scene_scalars(xy2angular, disc, radii, anchors)
        stacked = torch.empty(
            (len(requested), ny, nx), dtype=torch.float32, device=device
        )
        launch(scene, stacked, nx, ny, row0)
        out = {}
        for k, name in enumerate(requested):
            plane = stacked[k]
            if name == 'RADIAL-VELOCITY':
                plane = plane.to(torch.float64)
            out[name] = plane
        return out

    impl.launch = launch
    return impl
