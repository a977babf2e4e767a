"""
Base classes: session management, caching, time utilities and the
common machinery shared by Body/BasicBody/BodyXY/Observation.

Port of ``planetmapper_tpu.base``, mirroring the reference's
``planetmapper/base.py`` (SpiceBase base.py:202, BodyBase base.py:786)
without any CSPICE dependency: body-name handling goes through the built-in
NAIF table, time conversion through the LSK-driven time module, and target
states through the float64 PyTorch ephemeris engine.
"""

from __future__ import annotations

import datetime
import functools
import math
import numbers
from collections.abc import Collection, Sequence
from typing import Any, Callable, TypeVar

import numpy as np
import torch

from . import progress
from ._device import call_device, f64
from .core.ephemeris import (
    Ephemeris,
    InsufficientDataError,
    get_ephemeris,
)
from .core.time import LeapSecondData, et_to_utc_string, utc_string_to_et
from .core.timebase import SPEED_OF_LIGHT_KM_S
from .kernels import naif_ids
from .kernels.pool import (  # noqa: F401  (re-exported for API parity)
    DEFAULT_KERNEL_PATH,
    clear_kernels,
    get_kernel_path,
    get_pool,
    load_kernels,
    prevent_kernel_loading,
    set_kernel_path,
    sort_kernel_paths,
)

Numeric = TypeVar('Numeric', bound=float | np.ndarray)
FloatOrArray = TypeVar('FloatOrArray', float, np.ndarray)

_KERNEL_HELP_TEXT = (
    'Check your SPICE kernels are set up correctly and cover the requested '
    'bodies and times.'
)


def _kernel_error_help_note() -> str:
    """
    Kernel-troubleshooting note appended to kernel-data errors (parity with
    the reference's SPICE-error help decorator, base.py:141-171): states the
    resolved kernel directory and *why* that directory was chosen.
    """
    path, source = get_kernel_path(return_source=True)
    return (
        f'{_KERNEL_HELP_TEXT}\n'
        f'Kernel directory path: {path}\n'
        f'Kernel path source: {source}'
    )


class SpiceError(Exception):
    """Base error for kernel-data problems (parity with SpiceyPyError)."""


class NotFoundError(SpiceError):
    """
    Raised when a computation finds no solution (e.g. a ray misses the
    target's surface), mirroring spiceypy's NotFoundError semantics.
    """


class BodiesNotDistinctError(SpiceError):
    """Raised when target and observer coincide (SpiceBODIESNOTDISTINCT)."""


def _cache_clearable_result(fn):
    """
    Cache a method result in ``self._cache`` keyed by function name and
    arguments (cleared when disc parameters etc. change). Numpy array
    arguments are converted to nested tuples for hashability.
    """

    @functools.wraps(fn)
    def decorated(self, *args_in, **kwargs_in):
        args, kwargs = _replace_np_arr_args_with_tuples(args_in, kwargs_in)
        key = (fn.__name__, args, frozenset(kwargs.items()))
        if key not in self._cache:
            self._cache[key] = fn(self, *args, **kwargs)
        return self._cache[key]

    return decorated


def _cache_stable_result(fn):
    """Like :func:`_cache_clearable_result` but in the never-cleared cache."""

    @functools.wraps(fn)
    def decorated(self, *args_in, **kwargs_in):
        args, kwargs = _replace_np_arr_args_with_tuples(args_in, kwargs_in)
        key = (fn.__name__, args, frozenset(kwargs.items()))
        if key not in self._stable_cache:
            self._stable_cache[key] = fn(self, *args, **kwargs)
        return self._stable_cache[key]

    return decorated


def _as_readonly_view(arr: np.ndarray) -> np.ndarray:
    out = np.asarray(arr).view()
    out.setflags(write=False)
    return out


def _return_readonly_array(fn):
    @functools.wraps(fn)
    def decorated(self, *args, **kwargs):
        return _as_readonly_view(fn(self, *args, **kwargs))

    return decorated


def _on_tensors(fn):
    """
    Run a transform written on float64 tensors for every caller. With a
    tensor among the arguments, they all go in on the device of the call
    (``_device.call_device``: their own for a bulk call, the host for a
    small one) and the results stay tensors there. Numbers and numpy arrays
    go in as CPU tensors, and the results come back as numpy arrays, or as
    numbers where a result is 0-d (one point).
    """

    @functools.wraps(fn)
    def decorated(self, *args, **kwargs):
        if any(isinstance(a, torch.Tensor) for a in args):
            device = call_device(*args)
            return fn(self, *(f64(a, device) for a in args), **kwargs)
        return _host_values(fn(self, *(f64(a) for a in args), **kwargs))

    return decorated


def _host_values(out):
    """CPU tensors (or a tuple of them) as numpy arrays, 0-d ones as numbers."""
    if isinstance(out, tuple):
        return tuple(_host_values(v) for v in out)
    return out.item() if out.ndim == 0 else out.numpy()


def _broadcast_to(a, shape: tuple[int, ...]):
    """``a`` (a tensor, a number or an array) broadcast to ``shape``: a
    tensor as a view on its own device, anything else as a float numpy
    array."""
    if isinstance(a, torch.Tensor):
        return a.expand(shape)
    return np.broadcast_arrays(np.asarray(a, dtype=float),
                               np.empty(shape, dtype=bool))[0]


def _replace_np_arr_args_with_tuples(args: tuple, kwargs: dict):
    args = tuple(_maybe_np_arr_to_tuple(a) for a in args)
    kwargs = {k: _maybe_np_arr_to_tuple(v) for k, v in kwargs.items()}
    return args, kwargs


def _maybe_np_arr_to_tuple(o: Any) -> Any:
    if isinstance(o, np.ndarray):
        return _to_tuple(o)
    return o


def _to_tuple(arr: np.ndarray):
    if arr.ndim > 1:
        return tuple(_to_tuple(a) for a in arr)
    if arr.ndim == 1:
        return tuple(arr)
    return float(arr)


class SpiceBase:
    """
    Base class for all planetmapper_tpu_torch objects: kernel/session
    management, caching, progress hooks, time conversion and generic
    helpers.

    Parity with the reference's ``SpiceBase`` (base.py:202-783). As in the
    JAX package, ``optimize_speed`` gates the backplane pipeline's
    off-disc short circuit.
    """

    _DEFAULT_DTM_FORMAT_STRING = '%Y-%m-%dT%H:%M:%S.%f'

    def __init__(
        self,
        show_progress: bool = False,
        optimize_speed: bool = True,
        auto_load_kernels: bool = True,
        kernel_path: str | None = None,
        manual_kernels: None | list[str] = None,
    ) -> None:
        super().__init__()
        self._show_progress = show_progress
        self._optimize_speed = optimize_speed
        self._auto_load_kernels = auto_load_kernels
        self._kernel_path = kernel_path
        self._manual_kernels = manual_kernels

        self._cache: dict = {}
        self._stable_cache: dict = {}

        self._progress_hook: progress.ProgressHook | None = None
        self._progress_call_stack: list[str] = []

        if show_progress:
            self._set_progress_hook(progress.CLIProgressHook())

        if auto_load_kernels:
            self.load_spice_kernels(
                kernel_path=kernel_path, manual_kernels=manual_kernels
            )

        # Create the CUDA context on a thread while the scene is built; a
        # no-op after the first call and for a body off the card (a
        # BodyXY sets its device before this runs; see the _session_warm
        # module docstring)
        from ._session_warm import start_session_warm

        start_session_warm(getattr(self, 'device', None))

    # -- infrastructure shared with the reference API ----------------------
    def __repr__(self) -> str:
        return self._generate_repr()

    def _generate_repr(
        self,
        *arg_keys: str,
        kwarg_keys: Sequence[str] = (),
        skip_keys: Collection[str] = (),
        formatters: dict[str, Callable[[Any], str]] | None = None,
    ) -> str:
        if formatters is None:
            formatters = {}
        kwargs = self._get_kwargs()
        defaults = self._get_default_init_kwargs()
        skip_keys = set(skip_keys) | set(kwarg_keys) | set(arg_keys)

        kw_to_include = {k: kwargs[k] for k in kwarg_keys}
        kw_to_include.update(
            {
                k: v
                for k, v in kwargs.items()
                if (k not in skip_keys and k not in defaults)
            }
        )
        kw_to_include.update(
            {
                k: kwargs[k]
                for k, d in defaults.items()
                if (k not in skip_keys and not np.array_equal(kwargs[k], d))
            }
        )
        arguments: list[str] = [
            formatters.get(k, repr)(kwargs[k]) for k in arg_keys
        ]
        arguments.extend(
            f'{k}={formatters.get(k, repr)(v)}' for k, v in kw_to_include.items()
        )
        return f'{self.__class__.__name__}({", ".join(arguments)})'

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SpiceBase)
            and type(self) is type(other)
            and self._get_equality_tuple() == other._get_equality_tuple()
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._get_equality_tuple()))

    def _get_equality_tuple(self) -> tuple:
        return (self._optimize_speed,)

    def _get_kwargs(self) -> dict[str, Any]:
        return dict(
            show_progress=self._show_progress,
            optimize_speed=self._optimize_speed,
            auto_load_kernels=self._auto_load_kernels,
            kernel_path=self._kernel_path,
            manual_kernels=self._manual_kernels,
        )

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        return dict(
            show_progress=False,
            optimize_speed=True,
            auto_load_kernels=True,
            kernel_path=None,
            manual_kernels=None,
        )

    def _copy_options_to_other(self, other: 'SpiceBase') -> None:
        pass

    def __copy__(self):
        new = self.__class__(**self._get_kwargs())
        self._copy_options_to_other(new)
        return new

    def copy(self):
        """Return a copy of this object."""
        return self.__copy__()

    def __replace__(self, **changes):
        new = self.__class__(**(self._get_kwargs() | changes))
        self._copy_options_to_other(new)
        return new

    def replace(self, **changes):
        """Return a copy of this object with the specified changes applied."""
        return self.__replace__(**changes)

    def _clear_cache(self) -> None:
        self._cache.clear()

    # -- kernel/session access ---------------------------------------------
    @staticmethod
    def load_spice_kernels(
        kernel_path: str | None = None,
        manual_kernels: None | list[str] = None,
        only_if_needed: bool = True,
    ) -> None:
        """Load kernels once per session (reference base.py:553-611)."""
        from .kernels import pool as pool_mod

        pool_mod.load_spice_kernels(
            kernel_path=kernel_path,
            manual_kernels=manual_kernels,
            only_if_needed=only_if_needed,
        )

    @staticmethod
    def _pool():
        return get_pool()

    @staticmethod
    def _ephemeris() -> Ephemeris:
        return get_ephemeris()

    @classmethod
    def _lsk(cls) -> LeapSecondData:
        return LeapSecondData.from_pool(get_pool().text)

    def standardise_body_name(
        self, name: str | int, *, raise_if_not_found: bool = False
    ) -> str:
        """
        Standardised (NAIF-preferred) version of a body name; parity with
        reference base.py:448-482.
        """
        pool = get_pool()
        extra_ids, extra_names = pool.extra_body_names()
        try:
            code = naif_ids.bods2c(name, extra_ids)
            return naif_ids.bodc2s(code, extra_names)
        except naif_ids.BodyNotFoundError:
            if raise_if_not_found:
                raise NotFoundError(f'Body name {name!r} could not be resolved')
            return str(name)

    # -- time ----------------------------------------------------------------
    def et2dtm(self, et: float) -> datetime.datetime:
        """Ephemeris time to timezone-aware UTC datetime (base.py:484)."""
        s = et_to_utc_string(et, self._lsk(), 6) + '+0000'
        return datetime.datetime.strptime(s, '%Y-%m-%dT%H:%M:%S.%f%z')

    @staticmethod
    def mjd2dtm(mjd: float) -> datetime.datetime:
        """Modified Julian Date to timezone-aware UTC datetime (base.py:499)."""
        from .core.timebase import j2000_seconds_to_calendar

        # Difference against the J2000 epoch in MJD directly: adding the
        # 2.4e6-day JD offset first would lose ~40 us to f64 rounding
        t = (float(mjd) - 51544.5) * 86400.0
        # Round to microseconds like a datetime can represent
        t = round(t * 1e6) / 1e6
        year, month, day, hour, minute, sec = j2000_seconds_to_calendar(t)
        micro = int(round((sec - int(sec)) * 1e6))
        sec_int = int(sec)
        if micro >= 1000000:
            micro -= 1000000
            sec_int += 1
        return datetime.datetime(
            year, month, day, hour, minute, sec_int, micro,
            tzinfo=datetime.timezone.utc,
        )

    def speed_of_light(self) -> float:
        """Speed of light in km/s (``spice.clight`` value)."""
        return SPEED_OF_LIGHT_KM_S

    def calculate_doppler_factor(self, radial_velocity: Numeric) -> Numeric:
        """
        Doppler factor sqrt((1 + v/c)/(1 - v/c)) for a radial velocity
        (positive = away from observer). Reference base.py:524-551.
        """
        beta = radial_velocity / self.speed_of_light()
        return np.sqrt((1 + beta) / (1 - beta))  # type: ignore[return-value]

    # -- generic numeric helpers ---------------------------------------------
    @staticmethod
    def close_loop(arr: np.ndarray) -> np.ndarray:
        """Append the first element to the end of an array (base.py:613)."""
        return np.append(arr, [arr[0]], axis=0)

    @staticmethod
    def unit_vector(v: np.ndarray) -> np.ndarray:
        """Normalised copy of a vector."""
        return v / (sum(v * v)) ** 0.5

    @staticmethod
    def vector_magnitude(v: np.ndarray) -> float:
        """Magnitude of a vector."""
        return (sum(v * v)) ** 0.5

    @_on_tensors
    def _radian_pair2degrees(self, radians0, radians1):
        return torch.rad2deg(radians0), torch.rad2deg(radians1)

    @_on_tensors
    def _degree_pair2radians(self, degrees0, degrees1):
        return torch.deg2rad(degrees0), torch.deg2rad(degrees1)

    @staticmethod
    def _rotation_matrix_radians(theta: float) -> np.ndarray:
        return np.array(
            [[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]]
        )

    @staticmethod
    def angular_dist(ra1, dec1, ra2, dec2):
        """Angular distance in degrees between two RA/Dec points."""
        return np.rad2deg(
            np.arccos(
                np.clip(
                    np.sin(np.deg2rad(dec1)) * np.sin(np.deg2rad(dec2))
                    + np.cos(np.deg2rad(dec1))
                    * np.cos(np.deg2rad(dec2))
                    * np.cos(np.deg2rad(ra1) - np.deg2rad(ra2)),
                    -1.0,
                    1.0,
                )
            )
        )

    @staticmethod
    def _maybe_transform_as_arrays(
        func: Callable, arg1, arg2, *args, **kwargs
    ):
        """
        Dispatch a two-argument transform over floats or broadcast arrays.

        Where the reference loops a scalar FFI call with ``np.nditer``
        (base.py:718-759), here ``func`` is expected to handle batched
        inputs natively (the underlying geometry is batched tensor code), so
        arrays are simply broadcast to one shape and passed through in one
        call, each as it came: tensors where they are, the rest as numpy.
        Where the call runs is left to ``func``'s transforms
        (:func:`_on_tensors`).
        """
        numeric_types = (float, numbers.Number)
        if isinstance(arg1, numeric_types) and isinstance(arg2, numeric_types):
            return func(arg1, arg2, *args, **kwargs)
        shape = np.broadcast_shapes(np.shape(arg1), np.shape(arg2))
        return func(
            _broadcast_to(arg1, shape), _broadcast_to(arg2, shape),
            *args, **kwargs,
        )

    # -- progress hooks ------------------------------------------------------
    def _set_progress_hook(self, progress_hook: progress.ProgressHook) -> None:
        self._progress_hook = progress_hook
        self._progress_call_stack = []

    def _get_progress_hook(self) -> progress.ProgressHook | None:
        return self._progress_hook

    def _remove_progress_hook(self) -> None:
        hook = self._progress_hook
        close = getattr(hook, 'close', None)
        if close is not None:
            close()  # never leak an open progress bar
        self._progress_hook = None
        self._progress_call_stack = []

    def _update_progress_hook(self, progress_frac: float) -> None:
        if self._progress_hook is not None:
            self._progress_hook(progress_frac, self._progress_call_stack)


class BodyBase(SpiceBase):
    """
    Common target/observer/time state for Body and BasicBody (parity with
    reference base.py:786-906).
    """

    def __init__(
        self,
        *,
        target: str | int,
        utc: str | datetime.datetime | float | None,
        observer: str | int,
        aberration_correction: str,
        observer_frame: str,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)

        utc = self._standardise_utc_to_string(utc)

        self.target = self.standardise_body_name(target)
        self.observer = self.standardise_body_name(observer)
        self.observer_frame = observer_frame
        self.aberration_correction = aberration_correction

        lsk = self._lsk()
        self.et = float(utc_string_to_et(utc, lsk))
        self.dtm: datetime.datetime = self.et2dtm(self.et)
        self.utc = self.dtm.strftime(self._DEFAULT_DTM_FORMAT_STRING)

        pool = get_pool()
        extra_ids, _ = pool.extra_body_names()
        try:
            self.target_body_id: int = naif_ids.bods2c(self.target, extra_ids)
            self._observer_body_id: int = naif_ids.bods2c(
                self.observer, extra_ids
            )
        except naif_ids.BodyNotFoundError as exc:
            raise NotFoundError(str(exc)) from exc

        if self.target_body_id == self._observer_body_id:
            raise BodiesNotDistinctError(
                f'Target and observer ({self.target!r}) must be distinct '
                'bodies'
            )

        eph = self._ephemeris()
        try:
            state, lt = eph.spkezr(
                self.target_body_id,
                self._observer_body_id,
                self.et,
                self.aberration_correction,
            )
        except InsufficientDataError as exc:
            raise SpiceError(
                str(exc) + '\n\n' + _kernel_error_help_note()
            ) from exc
        state = np.asarray(state)
        self._target_obsvec = state[:3]
        self.target_light_time = float(lt)
        self.target_distance = self.target_light_time * self.speed_of_light()
        ra, dec = self._obsvec2radec(self._target_obsvec)
        self.target_ra = float(ra)
        self.target_dec = float(dec)

    @classmethod
    def _standardise_utc_to_string(
        cls, utc: str | datetime.datetime | float | None
    ) -> str:
        if isinstance(utc, (float, int, numbers.Number)) and not isinstance(
            utc, bool
        ):
            utc = cls.mjd2dtm(float(utc))  # type: ignore[arg-type]
        if utc is None:
            utc = datetime.datetime.now(datetime.timezone.utc)
        if isinstance(utc, datetime.datetime):
            if utc.tzinfo is None:
                utc = utc.replace(tzinfo=datetime.timezone.utc)
            utc = utc.astimezone(tz=datetime.timezone.utc)
            utc = utc.strftime(cls._DEFAULT_DTM_FORMAT_STRING)
        return utc

    def __repr__(self) -> str:
        return self._generate_repr()

    def _get_equality_tuple(self) -> tuple:
        return (
            self.target,
            self.utc,
            self.observer,
            self.observer_frame,
            self.aberration_correction,
            super()._get_equality_tuple(),
        )

    def _get_kwargs(self) -> dict[str, Any]:
        return super()._get_kwargs() | dict(
            target=self.target,
            utc=self.utc,
            observer=self.observer,
            aberration_correction=self.aberration_correction,
            observer_frame=self.observer_frame,
        )

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        return dict(**super()._get_default_init_kwargs())

    @_on_tensors
    def _obsvec2radec_radians(self, obsvec):
        """
        Observer-frame rectangular vector(s) to RA/Dec in radians (NaN for
        one non-finite vector).
        """
        if obsvec.ndim == 1 and not bool(torch.isfinite(obsvec).all()):
            nan = obsvec.new_tensor(math.nan)
            return nan, nan
        ra = torch.remainder(torch.atan2(obsvec[..., 1], obsvec[..., 0]),
                             2 * np.pi)
        norm = torch.sqrt(torch.sum(obsvec * obsvec, dim=-1))
        dec = torch.asin(torch.clamp(obsvec[..., 2] / norm, -1.0, 1.0))
        return ra, dec

    def _obsvec2radec(self, obsvec: np.ndarray):
        return self._radian_pair2degrees(*self._obsvec2radec_radians(obsvec))
