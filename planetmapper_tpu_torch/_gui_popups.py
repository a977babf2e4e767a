"""
Popup windows for the GUI: open/save dialogs with apply-cancel semantics,
threaded save progress with cancellation, FITS header display, and the
spectrum popup for cube observations (feature parity with the reference's
Popup hierarchy, gui.py:2402-4028).

This module imports tkinter: the GUI loads it only when it opens a popup.
A save runs on a worker thread; the observation's device work there goes
to the same CUDA stream as the main thread's, and a cancelled save
synchronises that device before it removes its files.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any

import numpy as np

import tkinter as tk
from tkinter import filedialog, messagebox, ttk

from . import utils
from .observation import Observation


class PopupAlreadyOpenError(Exception):
    """Raised when a single-instance popup is already open."""


class Popup:
    """
    Base popup: registers with the GUI (so popups can be closed as a
    group), optionally enforces a single open instance per popup id, and
    provides validated numeric getters.
    """

    #: Single-instance popups defer to the already-open window
    single_instance = True

    def __init__(self, gui, title: str) -> None:
        self.gui = gui
        self.title = title
        self.is_open = False
        self.window: tk.Toplevel | None = None
        already_open = self.maybe_get_already_open_popup()
        if already_open is not None and self.single_instance:
            already_open.give_focus()
            return
        gui.add_popup(self)
        self.create_window()
        self.is_open = True
        self.make_widget()

    def get_popup_id(self) -> str:
        return type(self).__name__

    def maybe_get_already_open_popup(self) -> 'Popup | None':
        for popup in self.gui.get_popups():
            if popup.get_popup_id() == self.get_popup_id() and popup.is_open:
                return popup
        return None

    def create_window(self) -> None:
        self.window = tk.Toplevel(self.gui.root)
        self.window.title(self.title)
        self.window.transient(self.gui.root)
        self.window.protocol('WM_DELETE_WINDOW', self.close_window)
        self.window.bind('<Escape>', self.close_window)

    def make_widget(self) -> None:  # pragma: no cover - overridden
        pass

    def give_focus(self) -> None:
        if self.window is not None:
            self.window.lift()
            self.window.focus_set()

    def close_window(self, *_: Any) -> None:
        self.is_open = False
        self.gui.remove_popup(self)
        if self.window is not None:
            self.window.destroy()
            self.window = None

    # -- validated getters --------------------------------------------------
    def get_float(
        self, var: tk.StringVar, name: str, *,
        positive: bool = False, allow_none: bool = False,
    ) -> float | None:
        raw = var.get().strip()
        if not raw:
            if allow_none:
                return None
            raise ValueError(f'{name} must be given')
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(f'{name} must be a number (got {raw!r})')
        if positive and value <= 0:
            raise ValueError(f'{name} must be positive')
        return value

    def get_int(self, var: tk.StringVar, name: str) -> int:
        value = self.get_float(var, name)
        assert value is not None
        if value != int(value):
            raise ValueError(f'{name} must be an integer')
        return int(value)


class OpenObservation(Popup):
    """
    Open dialog: path browser plus target/time/observer fields (the
    fields pre-fill from FITS headers when possible; non-FITS images need
    the user to provide them).
    """

    def __init__(self, gui, first_run: bool = False, *,
                 device=None) -> None:
        self.first_run = first_run
        #: where the opened observation runs (default: the GUI's device,
        #: itself the card unless the GUI was given another)
        self.device = device if device is not None else gui.device
        super().__init__(gui, 'Open observation')

    def make_widget(self) -> None:
        assert self.window is not None
        body = ttk.Frame(self.window)
        body.pack(fill='both', expand=True, padx=8, pady=8)

        row = ttk.Frame(body)
        row.pack(fill='x', pady=2)
        ttk.Label(row, text='File', width=10).pack(side='left')
        self.path_var = tk.StringVar()
        ttk.Entry(row, textvariable=self.path_var, width=40).pack(
            side='left', fill='x', expand=True
        )
        ttk.Button(row, text='Browse...', command=self.browse).pack(
            side='left'
        )

        self.field_vars: dict[str, tk.StringVar] = {}
        for key, label in (
            ('target', 'Target'), ('utc', 'Date (UTC)'),
            ('observer', 'Observer'),
        ):
            row = ttk.Frame(body)
            row.pack(fill='x', pady=2)
            ttk.Label(row, text=label, width=10).pack(side='left')
            var = tk.StringVar()
            ttk.Entry(row, textvariable=var, width=30).pack(side='left')
            self.field_vars[key] = var
        self.field_vars['observer'].set('EARTH')
        hint = ttk.Label(
            body,
            text=(
                'Leave fields blank to use values from the FITS header '
                '(target/date are required for plain image files).'
            ),
            wraplength=380,
        )
        hint.pack(fill='x', pady=4)

        bar = ttk.Frame(self.window)
        bar.pack(fill='x', padx=8, pady=4)
        ttk.Button(bar, text='OK', command=self.click_ok).pack(side='left')
        ttk.Button(bar, text='Cancel', command=self.click_cancel).pack(
            side='left'
        )

    def browse(self) -> None:
        path = filedialog.askopenfilename(
            title='Open observation',
            parent=self.window,
            filetypes=[
                ('FITS files', '*.fits *.fits.gz *.FITS'),
                ('Images', '*.png *.jpg *.jpeg *.PNG'),
                ('All files', '*'),
            ],
        )
        if path:
            self.path_var.set(path)

    def click_ok(self) -> None:
        if self.apply_changes():
            self.close_window()

    def click_cancel(self) -> None:
        self.close_window()

    def apply_changes(self) -> bool:
        path = self.path_var.get().strip()
        if not path:
            messagebox.showwarning(
                'No file', 'Choose a file to open', parent=self.window
            )
            return False
        kwargs: dict[str, Any] = {}
        for key, var in self.field_vars.items():
            value = var.get().strip()
            if value:
                kwargs[key] = value
        try:
            observation = Observation(path, device=self.device, **kwargs)
        except Exception as exc:
            traceback.print_exc()
            messagebox.showerror(
                'Error opening observation',
                f'{exc}\n\nCheck the target/date fields and your SPICE '
                'kernels cover the requested body and time.',
                parent=self.window,
            )
            return False
        self.gui.set_observation(observation)
        return True


class SaveObservation(Popup):
    """
    Save dialog: navigated-observation and mapped-observation outputs can
    each be toggled, with per-output paths and map projection /
    interpolation / resolution options.
    """

    def __init__(self, gui) -> None:
        super().__init__(gui, 'Save observation')

    def make_widget(self) -> None:
        from .gui import MAP_INTERPOLATIONS, MAP_PROJECTIONS

        assert self.window is not None
        obs = self.gui.get_observation()
        body = ttk.Frame(self.window)
        body.pack(fill='both', expand=True, padx=8, pady=8)

        # -- navigated output ------------------------------------------------
        self.save_nav_var = tk.BooleanVar(value=True)
        nav_frame = ttk.LabelFrame(body, text='Navigated observation')
        nav_frame.pack(fill='x', pady=4)
        ttk.Checkbutton(
            nav_frame, text='Save navigated observation',
            variable=self.save_nav_var,
        ).pack(anchor='w')
        row = ttk.Frame(nav_frame)
        row.pack(fill='x')
        ttk.Label(row, text='Path', width=6).pack(side='left')
        self.nav_path_var = tk.StringVar(
            value=obs.make_filename(suffix='_nav')
        )
        ttk.Entry(row, textvariable=self.nav_path_var, width=38).pack(
            side='left', fill='x', expand=True
        )
        ttk.Button(
            row, text='...',
            command=lambda: self._browse_save(self.nav_path_var), width=3,
        ).pack(side='left')

        # -- mapped output ---------------------------------------------------
        self.save_map_var = tk.BooleanVar(value=False)
        map_frame = ttk.LabelFrame(body, text='Mapped observation')
        map_frame.pack(fill='x', pady=4)
        ttk.Checkbutton(
            map_frame, text='Save mapped observation',
            variable=self.save_map_var,
        ).pack(anchor='w')
        row = ttk.Frame(map_frame)
        row.pack(fill='x')
        ttk.Label(row, text='Path', width=6).pack(side='left')
        self.map_path_var = tk.StringVar(
            value=obs.make_filename(suffix='_map')
        )
        ttk.Entry(row, textvariable=self.map_path_var, width=38).pack(
            side='left', fill='x', expand=True
        )
        ttk.Button(
            row, text='...',
            command=lambda: self._browse_save(self.map_path_var), width=3,
        ).pack(side='left')

        grid = ttk.Frame(map_frame)
        grid.pack(fill='x', pady=2)
        ttk.Label(grid, text='Projection', width=12).grid(row=0, column=0)
        self.projection_var = tk.StringVar(value='rectangular')
        ttk.OptionMenu(
            grid, self.projection_var, 'rectangular', *MAP_PROJECTIONS
        ).grid(row=0, column=1, sticky='w')
        ttk.Label(grid, text='Interpolation', width=12).grid(row=1, column=0)
        self.interpolation_var = tk.StringVar(value='linear')
        ttk.OptionMenu(
            grid, self.interpolation_var, 'linear', *MAP_INTERPOLATIONS
        ).grid(row=1, column=1, sticky='w')
        ttk.Label(grid, text='Degree interval', width=12).grid(
            row=2, column=0
        )
        self.degree_interval_var = tk.StringVar(value='1')
        ttk.Entry(
            grid, textvariable=self.degree_interval_var, width=8
        ).grid(row=2, column=1, sticky='w')
        ttk.Label(grid, text='Size (ortho/azim)', width=14).grid(
            row=3, column=0
        )
        self.size_var = tk.StringVar(value='100')
        ttk.Entry(grid, textvariable=self.size_var, width=8).grid(
            row=3, column=1, sticky='w'
        )

        self.keep_open_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(
            body, text='Keep this window open after saving',
            variable=self.keep_open_var,
        ).pack(anchor='w')

        bar = ttk.Frame(self.window)
        bar.pack(fill='x', padx=8, pady=4)
        ttk.Button(bar, text='Save', command=self.click_save).pack(
            side='left'
        )
        ttk.Button(bar, text='Cancel', command=self.click_cancel).pack(
            side='left'
        )

    def _browse_save(self, var: tk.StringVar) -> None:
        path = filedialog.asksaveasfilename(
            parent=self.window,
            defaultextension='.fits',
            initialfile=os.path.basename(var.get()),
        )
        if path:
            var.set(path)

    def get_map_kwargs(self) -> dict[str, Any]:
        projection = self.projection_var.get()
        kwargs: dict[str, Any] = {
            'interpolation': self.interpolation_var.get(),
        }
        if projection == 'rectangular':
            kwargs['degree_interval'] = float(
                self.degree_interval_var.get()
            )
        else:
            kwargs['projection'] = {
                'orthographic': 'orthographic',
                'azimuthal': 'azimuthal',
                'azimuthal equal area': 'azimuthal equal area',
            }[projection]
            kwargs['size'] = int(float(self.size_var.get()))
        return kwargs

    def click_save(self) -> None:
        save_nav = bool(self.save_nav_var.get())
        save_map = bool(self.save_map_var.get())
        if not (save_nav or save_map):
            messagebox.showwarning(
                'Nothing to save', 'Select at least one output',
                parent=self.window,
            )
            return
        try:
            map_kwargs = self.get_map_kwargs() if save_map else {}
        except ValueError as exc:
            messagebox.showwarning(
                'Invalid value', str(exc), parent=self.window
            )
            return
        progress = SavingProgress(
            self.gui,
            nav_path=self.nav_path_var.get() if save_nav else None,
            map_path=self.map_path_var.get() if save_map else None,
            map_kwargs=map_kwargs,
        )
        progress.start()
        if not self.keep_open_var.get():
            self.close_window()

    def click_cancel(self) -> None:
        self.close_window()


class SavingProgress(Popup):
    """
    Modal progress window: runs the save(s) on a worker thread, maps
    progress-hook events to progress bars, and cancels by raising
    :class:`planetmapper_tpu_torch.gui.CancelSave` from inside the hook.
    """

    single_instance = True

    def __init__(
        self, gui, *, nav_path: str | None, map_path: str | None,
        map_kwargs: dict[str, Any] | None = None,
    ) -> None:
        self.nav_path = nav_path
        self.map_path = map_path
        self.map_kwargs = map_kwargs or {}
        self.cancelled = False
        self.finished = False
        self.error: Exception | None = None
        self.progress_value = 0.0
        self.status = 'Preparing...'
        super().__init__(gui, 'Saving...')

    def make_widget(self) -> None:
        assert self.window is not None
        body = ttk.Frame(self.window)
        body.pack(fill='both', expand=True, padx=10, pady=8)
        self.status_label = ttk.Label(body, text=self.status, width=50)
        self.status_label.pack(fill='x', pady=2)
        self.bar = ttk.Progressbar(
            body, maximum=1.0, length=360, mode='determinate'
        )
        self.bar.pack(fill='x', pady=4)
        self.cancel_button = ttk.Button(
            body, text='Cancel', command=self.click_cancel
        )
        self.cancel_button.pack(pady=4)
        self.window.bind('<Escape>', self.press_escape)

    def start(self) -> None:
        if not self.is_open:
            # A save is already in progress (single-instance popup
            # deferred to it): don't spawn a second concurrent writer
            return
        thread = threading.Thread(target=self.run_save, daemon=True)
        thread.start()
        self._poll()

    def click_cancel(self) -> None:
        self.cancelled = True
        self.status = 'Cancelling...'

    def press_escape(self, *_: Any) -> None:
        self.click_cancel()

    def _progress_hook(self, progress: float, stack: list[str]) -> None:
        from .gui import CancelSave

        if self.cancelled:
            raise CancelSave()
        self.progress_value = float(progress)

    def run_save(self) -> None:
        from .gui import CancelSave

        obs = self.gui.get_observation()
        obs._set_progress_hook(self._progress_hook)
        try:
            if self.nav_path:
                self.status = f'Saving {os.path.basename(self.nav_path)}'
                obs.save_observation(self.nav_path, print_info=False)
            if self.map_path:
                self.progress_value = 0.0
                self.status = f'Saving {os.path.basename(self.map_path)}'
                obs.save_mapped_observation(
                    self.map_path, print_info=False, **self.map_kwargs
                )
        except CancelSave:
            # work already queued on the card finishes before the files go
            _synchronise(obs)
            for path in (self.nav_path, self.map_path):
                try:
                    if path and os.path.exists(path):
                        os.remove(path)
                except OSError:
                    pass
        except Exception as exc:  # pragma: no cover - unexpected I/O
            traceback.print_exc()
            self.error = exc
        finally:
            obs._remove_progress_hook()
            self.finished = True

    def _poll(self) -> None:
        if self.window is None:
            return
        self.bar['value'] = self.progress_value
        self.status_label.configure(text=self.status)
        if self.finished:
            if self.error is not None:
                messagebox.showerror(
                    'Error saving file', str(self.error), parent=self.window
                )
            self.close_window()
            return
        self.window.after(100, self._poll)

    def close_window(self, *_: Any) -> None:
        if not self.finished:
            self.click_cancel()
            return  # the poll loop closes once the worker stops
        super().close_window()


def _synchronise(obs) -> None:
    """Wait for the work queued on ``obs``'s device (a no-op off CUDA)."""
    import torch

    device = torch.device(obs.device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class HeaderDisplay(Popup):
    """Read-only FITS header display (reference gui.py:3509-3547)."""

    def make_widget(self) -> None:
        assert self.window is not None
        text = tk.Text(self.window, width=84, height=36, wrap='none')
        scroll = ttk.Scrollbar(self.window, command=text.yview)
        text.configure(yscrollcommand=scroll.set)
        text.insert('1.0', self.get_header_string())
        text.configure(state='disabled')
        scroll.pack(side='right', fill='y')
        text.pack(fill='both', expand=True)

    def get_header_string(self) -> str:
        obs = self.gui.get_observation()
        header = getattr(obs, 'header', None)
        if header is None:
            return '(no FITS header)'
        try:
            return header.tostring(sep='\n')
        except Exception:
            return '\n'.join(f'{k} = {v}' for k, v in header.items())


class SpectrumPopup(Popup):
    """
    Spectrum of the clicked pixel for cube observations: wavelengths from
    the FITS header where available, log/linear y scale, and comparison
    spectra that can be pinned and copied as JSON
    (reference gui.py:3549-4028).
    """

    def __init__(self, gui) -> None:
        self.comparisons: list[tuple[tuple[float, float], np.ndarray, str]] = []
        self._color_cycle = 0
        self.yscale = 'linear'
        super().__init__(gui, 'Spectrum')

    def make_widget(self) -> None:
        import matplotlib.pyplot as plt  # noqa: F401  (backend ready)
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        from matplotlib.figure import Figure

        assert self.window is not None
        self.figure = Figure(figsize=(6, 4))
        self.ax = self.figure.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.figure, master=self.window)
        self.canvas.get_tk_widget().pack(fill='both', expand=True)

        bar = ttk.Frame(self.window)
        bar.pack(fill='x', padx=4, pady=4)
        ttk.Button(
            bar, text='Pin spectrum', command=self.add_comparison
        ).pack(side='left')
        ttk.Button(
            bar, text='Clear pinned', command=self.reset_comparisons
        ).pack(side='left')
        ttk.Button(
            bar, text='Copy data', command=self.copy_data_to_clipboard
        ).pack(side='left')
        self.log_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(
            bar, text='Log scale', variable=self.log_var,
            command=self.update,
        ).pack(side='left')
        self.update()

    # -- data ---------------------------------------------------------------
    def get_wavelengths(self) -> tuple[np.ndarray, str]:
        obs = self.gui.get_observation()
        header = getattr(obs, 'header', None)
        if header is not None:
            try:
                return (
                    utils.generate_wavelengths_from_header(header),
                    'Wavelength',
                )
            except utils.GetWavelengthsError:
                pass
        return np.arange(obs.data.shape[0], dtype=float), 'Index'

    def get_spectrum(
        self, click_location: tuple[float, float] | None
    ) -> np.ndarray | None:
        if click_location is None:
            return None
        obs = self.gui.get_observation()
        x, y = click_location
        ix, iy = int(round(x)), int(round(y))
        nz, ny, nx = obs.data.shape
        if not (0 <= ix < nx and 0 <= iy < ny):
            return None
        return np.asarray(obs.data[:, iy, ix], dtype=float)

    def add_comparison(self) -> None:
        click = self.gui.last_click_location
        spectrum = self.get_spectrum(click)
        if spectrum is None or click is None:
            return
        color = f'C{self._color_cycle % 10}'
        self._color_cycle += 1
        self.comparisons.append((click, spectrum, color))
        self.update()

    def reset_comparisons(self) -> None:
        self.comparisons.clear()
        self._color_cycle = 0
        self.update()

    def copy_data_to_clipboard(self) -> None:
        import json

        wavelengths, label = self.get_wavelengths()
        spectrum = self.get_spectrum(self.gui.last_click_location)
        data: dict[str, Any] = {
            'xlabel': label,
            'x': [float(v) for v in wavelengths],
        }
        if spectrum is not None:
            data['spectrum'] = [float(v) for v in spectrum]
        data['comparisons'] = [
            {
                'xy': list(click),
                'spectrum': [float(v) for v in values],
            }
            for click, values, _color in self.comparisons
        ]
        self.gui.copy_to_clipboard(json.dumps(data))

    # -- plot -----------------------------------------------------------------
    def update(self) -> None:
        wavelengths, xlabel = self.get_wavelengths()
        self.ax.clear()
        for click, spectrum, color in self.comparisons:
            self.ax.plot(
                wavelengths[: len(spectrum)], spectrum, color=color,
                alpha=0.7,
                label=f'({click[0]:.1f}, {click[1]:.1f})',
            )
        spectrum = self.get_spectrum(self.gui.last_click_location)
        if spectrum is not None:
            click = self.gui.last_click_location
            assert click is not None
            self.ax.plot(
                wavelengths[: len(spectrum)], spectrum, color='k',
                label=f'({click[0]:.1f}, {click[1]:.1f}) (current)',
            )
            self.ax.set_title(
                f'Spectrum at x={click[0]:.1f}, y={click[1]:.1f}'
            )
        else:
            self.ax.set_title('Click the observation to show a spectrum')
        self.ax.set_xlabel(xlabel)
        self.ax.set_ylabel('Value')
        if self.log_var.get():
            self.ax.set_yscale('log')
        if self.comparisons or spectrum is not None:
            self.ax.legend(fontsize='small')
        self.canvas.draw_idle()
