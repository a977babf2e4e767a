"""
Progress hook subsystem: nested progress reporting, CLI bars, and the
timing profiler.

Behavioural parity with the reference's ``planetmapper/progress.py``: hooks
are callables receiving ``(progress_fraction, call_stack)`` events emitted
by ``progress_decorator``-wrapped methods; they double as a tracing/
profiling layer (``TotalTimingProgressHook``) and as the cancellation
channel (hooks may raise to abort long-running saves, as the GUI does).
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Callable, ParamSpec, Protocol, TypeVar

T = TypeVar('T')
P = ParamSpec('P')


class ProgressHook(Protocol):
    """Protocol for progress hooks: ``hook(progress, call_stack)``."""

    def __call__(self, progress: float, stack: list[str]) -> None: ...


def progress_decorator(fn: Callable[P, T]) -> Callable[P, T]:
    """
    Decorator maintaining the progress call stack around a method call and
    emitting 0.0/1.0 events at entry/exit. The wrapped object must be a
    SpiceBase-derived instance (``self._progress_call_stack``).
    """

    @functools.wraps(fn)
    def decorated(self, *args, **kwargs):
        if self._get_progress_hook() is None:
            return fn(self, *args, **kwargs)
        name = fn.__qualname__
        self._progress_call_stack.append(name)
        try:
            self._update_progress_hook(0.0)
            result = fn(self, *args, **kwargs)
            self._update_progress_hook(1.0)
        finally:
            self._progress_call_stack.pop()
        return result

    return decorated


class CLIProgressHook:
    """Render progress as nested tqdm bars on the terminal."""

    def __init__(self, leave: bool = False) -> None:
        self._bars: dict[tuple[str, ...], object] = {}
        self._leave = leave

    def __call__(self, progress: float, stack: list[str]) -> None:
        try:
            from tqdm import tqdm
        except ImportError:  # pragma: no cover
            print(f'{" > ".join(stack)}: {progress:.0%}')
            return
        key = tuple(stack)
        bar = self._bars.get(key)
        if bar is None:
            bar = tqdm(
                total=100,
                desc='  ' * (len(stack) - 1) + (stack[-1] if stack else ''),
                leave=self._leave,
                bar_format='{desc}: {percentage:3.0f}%|{bar}|',
            )
            self._bars[key] = bar
        bar.n = int(progress * 100)  # type: ignore[attr-defined]
        bar.refresh()  # type: ignore[attr-defined]
        if progress >= 1.0:
            bar.close()  # type: ignore[attr-defined]
            del self._bars[key]


class TotalTimingProgressHook:
    """
    Profiler hook: records wall time spent in each progress frame and prints
    self-time vs total-time per function on demand (reference
    progress.py:80-102).
    """

    def __init__(self) -> None:
        self._last_time: float | None = None
        self._last_stack: tuple[str, ...] = ()
        self.total_times: dict[tuple[str, ...], float] = defaultdict(float)

    def __call__(self, progress: float, stack: list[str]) -> None:
        now = time.time()
        if self._last_time is not None and self._last_stack:
            self.total_times[self._last_stack] += now - self._last_time
        self._last_time = now
        self._last_stack = tuple(stack)

    def self_times(self) -> dict[str, float]:
        """Self-time per innermost function name."""
        out: dict[str, float] = defaultdict(float)
        for stack, t in self.total_times.items():
            if stack:
                out[stack[-1]] += t
        return dict(out)

    def summary(self) -> str:
        lines = ['Timing summary (self time per function):']
        for name, t in sorted(
            self.self_times().items(), key=lambda kv: -kv[1]
        ):
            lines.append(f'  {name}: {t:.3f}s')
        return '\n'.join(lines)

    def print_summary(self) -> None:
        print(self.summary())


class _WeightedProgressPart:
    def __init__(self, weight: float) -> None:
        self.weight = weight
        self.progress = 0.0


class WeightedProgressHook:
    """
    Aggregate progress across a sequence of sub-operations with relative
    weights (used by save routines where different backplane generators have
    very different costs; reference progress.py:106-199).
    """

    def __init__(
        self,
        parts: dict[str, float],
        parent_hook: ProgressHook | None = None,
    ) -> None:
        self.parts = {k: _WeightedProgressPart(w) for k, w in parts.items()}
        self.other_weight = 1.0
        self._other = _WeightedProgressPart(self.other_weight)
        self.parent_hook = parent_hook

    def overall_progress(self) -> float:
        total_weight = sum(p.weight for p in self.parts.values())
        if total_weight == 0:
            return 0.0
        return (
            sum(p.weight * min(p.progress, 1.0) for p in self.parts.values())
            / total_weight
        )

    def __call__(self, progress: float, stack: list[str]) -> None:
        for name in reversed(stack):
            # progress_decorator pushes qualified names
            # ('BodyXY._get_targvec_img'); part keys may be bare
            part = self.parts.get(name)
            if part is None and '.' in name:
                part = self.parts.get(name.rsplit('.', 1)[-1])
            if part is not None:
                part.progress = max(part.progress, progress)
                break
        if self.parent_hook is not None:
            self.parent_hook(self.overall_progress(), stack)


# Hand-benchmarked relative generator weights used to aggregate save
# progress (parity with the reference's implicit performance model,
# progress.py:158-194). On the GPU these are nearly equal - everything is
# one fused pipeline - but the keys are kept for API/metadata compatibility.
NAVIGATION_SAVE_WEIGHTS: dict[str, float] = {
    '_get_targvec_img': 10,
    '_get_lonlat_img': 5,
    '_get_radec_img': 1,
    '_get_illumination_gie_img': 5,
    '_get_state_imgs': 3,
    '_get_limb_coordinate_imgs': 2,
    '_get_ring_plane_coordinate_imgs': 5,
    'get_local_solar_time_img': 1,
}

class _SaveProgressHookCLI(WeightedProgressHook):
    """
    Weighted save progress rendered as a single tqdm percentage bar
    (reference progress.py:199-225). ``description`` labels the bar; the
    bar closes when overall progress reaches 100%.
    """

    description = 'Saving'

    def __init__(self, parts: dict[str, float]) -> None:
        super().__init__(parts)
        import tqdm

        self.bar = tqdm.tqdm(
            total=100,
            desc=self.get_description(),
            unit='%',
            bar_format=(
                '{l_bar}{bar}| [{elapsed}<{remaining}, {rate_fmt}{postfix}]'
            ),
            leave=True,
        )
        self._shown = 0.0

    def get_description(self) -> str:
        return self.description

    def update_bar(self, progress_change: float) -> None:
        self.bar.update(progress_change * 100)

    def __call__(self, progress: float, stack: list[str]) -> None:
        super().__call__(progress, stack)
        overall = self.overall_progress() * 100
        if overall > self._shown:
            self.update_bar((overall - self._shown) / 100)
            self._shown = overall
        # The outermost frame is the save routine itself: when it reports
        # completion, force the bar to 100% and close - parts that never
        # ran (skipped backplanes) must not leak an open bar
        if overall >= 100 or (
            len(stack) == 1 and progress >= 1.0
        ):
            self.close()

    def close(self) -> None:
        if not self.bar.disable:
            if self._shown < 100:
                self.bar.update(100 - self._shown)
                self._shown = 100.0
            self.bar.close()


class SaveNavProgressHookCLI(_SaveProgressHookCLI):
    """CLI progress bar for ``save_observation`` (reference progress.py:218)."""

    description = 'Saving observation'

    def __init__(self) -> None:
        super().__init__(dict(NAVIGATION_SAVE_WEIGHTS))


class SaveMapProgressHookCLI(_SaveProgressHookCLI):
    """CLI progress bar for ``save_mapped_observation`` (reference progress.py:223)."""

    description = 'Saving map'

    def __init__(self, n_wavelengths: int = 1) -> None:
        parts = dict(MAP_SAVE_WEIGHTS)
        parts['_get_mapped_data'] = max(int(n_wavelengths), 1) * 2.0
        super().__init__(parts)


MAP_SAVE_WEIGHTS: dict[str, float] = {
    '_targvec_map': 10,
    '_get_lonlat_centric_map': 1,
    '_radec_map': 1,
    '_illumf_map': 5,
    '_get_state_maps': 3,
    '_get_limb_coordinate_maps': 2,
    '_get_ring_plane_coordinate_maps': 5,
    'get_local_solar_time_map': 1,
    'map_img': 5,
}
