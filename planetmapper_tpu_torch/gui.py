"""
Graphical user interface for interactively fitting observations.

Feature parity with the reference's tkinter GUI
(``planetmapper/gui.py``): a plot of the observation with a
live, blitted wireframe overlay; keyboard shortcuts for adjusting the
disc; a disc-finding routine registry; a tabbed control panel (controls /
plot settings / disc finding / help); per-artist plot-settings editors;
image display modes (sum / single wavelength / RGB) with gamma and limit
controls; a WCS-offset section; a click-coordinate readout with formatted
and machine-readable (JSON) clipboard copies; a spectrum popup for cubes;
and open/save dialogs with threaded progress reporting and cancellation
(via an exception raised from the progress hook).

The architecture differs from the reference: plot components and their
settings editors are driven by declarative specs (:mod:`._gui_settings`),
and popups live in :mod:`._gui_popups`.

tkinter and matplotlib are imported when a window is first built or
drawn (:func:`_load_toolkits`), not when this module loads: a
:class:`GUI` made with ``allow_open=False`` holds an observation on the
card, runs the disc-finding routines and computes click coordinates on a
host that has neither. :class:`GUI`, :func:`run_gui` and the open dialog
take the port's ``device=`` for the observations they open (default: the
card).
"""

from __future__ import annotations

import os
import sys
import traceback
from collections import defaultdict
from typing import Any, Callable, Literal

import numpy as np

from . import common, utils
from .base import NotFoundError
from .observation import Observation

# Bound by _load_toolkits() when a window is first built or drawn (tests
# patch these names)
tk: Any = None
ttk: Any = None
messagebox: Any = None
plt: Any = None
Figure: Any = None
FigureCanvasTkAgg: Any = None
NavigationToolbar2Tk: Any = None

PlotKey = str
SetterKey = Literal['x0', 'y0', 'r0', 'rotation', 'step']

DEFAULT_PLOT_SETTINGS: dict[PlotKey, dict[str, Any]] = {
    'grid': dict(zorder=3.1, color='#333', linewidth=1, linestyle='dotted'),
    'terminator': dict(
        zorder=3.2, color='w', linewidth=1, linestyle='dashed'
    ),
    'limb': dict(zorder=3.3, color='w', linewidth=0.5, linestyle='solid'),
    'limb_illuminated': dict(
        zorder=3.31, color='w', linewidth=1, linestyle='solid'
    ),
    'ring': dict(zorder=3.4, color='w', linewidth=0.5, linestyle='solid'),
    'pole': dict(zorder=3.5, color='k', outline_color='w'),
    'coordinate_of_interest_lonlat': dict(
        zorder=3.6, marker='x', color='k', s=36
    ),
    'coordinate_of_interest_radec': dict(
        zorder=3.7, marker='+', color='k', s=36
    ),
    'other_body_of_interest_marker': dict(
        zorder=3.8, marker='+', color='w', s=36
    ),
    'other_body_of_interest_label': dict(zorder=3.81, color='grey'),
    'marked_coord': dict(
        zorder=4, color='cyan', linewidth=0.5, linestyle='solid'
    ),
    'image': dict(zorder=0.9, cmap='inferno'),
    '_': dict(
        grid_interval=30,
        grid_lat_limit=90,
        grid_planetocentric=False,
        image_mode='single',
        image_idx_single=0,
        image_idx_r=0,
        image_idx_g=1,
        image_idx_b=2,
        image_gamma=1,
        image_vmin=0,
        image_vmax=100,
        image_limit_type='relative',
    ),
}

LINESTYLES = ('solid', 'dashed', 'dotted', 'dashdot')
MARKERS = ('x', '+', 'o', '.', '*', 'v', '^', '<', '>', ',', 'D', 'd', '|', '_')
GRID_INTERVALS = ('10', '30', '45', '90')
CMAPS = ('gray', 'viridis', 'plasma', 'inferno', 'magma', 'cividis')
LIMIT_TYPES = ('relative', 'percentile', 'absolute')
MAP_INTERPOLATIONS = ('nearest', 'smooth', 'linear', 'quadratic', 'cubic')
MAP_PROJECTIONS = (
    'rectangular', 'orthographic', 'azimuthal', 'azimuthal equal area'
)

# X11 over SSH can crash opening fonts for high codepoints; optionally
# substitute ASCII (reference gui.py:128-146)
_X11_FONT_TRANSLATIONS = {'°': 'deg ', '′': "'", '″': '"', ' ': ' '}


def _use_x11_font_bugfix() -> bool:
    return bool(os.environ.get('PLANETMAPPER_USE_X11_FONT_BUGFIX', ''))


def _load_toolkits() -> None:
    """
    Import tkinter and matplotlib's Tk backend and bind the module names
    ``tk``, ``ttk``, ``messagebox``, ``plt``, ``Figure``,
    ``FigureCanvasTkAgg`` and ``NavigationToolbar2Tk`` (each one not bound
    yet). Without tkinter, raises the informative error of
    :mod:`._mock_gui_no_tk`.
    """
    global tk, ttk, messagebox, plt, Figure, FigureCanvasTkAgg
    global NavigationToolbar2Tk
    try:
        import tkinter
        from tkinter import messagebox as tk_messagebox
        from tkinter import ttk as tk_ttk
    except ImportError as exc:
        from ._mock_gui_no_tk import raise_tkinter_import_error

        raise_tkinter_import_error(exc)
    tk = tkinter if tk is None else tk
    ttk = tk_ttk if ttk is None else ttk
    messagebox = tk_messagebox if messagebox is None else messagebox
    if plt is None:
        import matplotlib.pyplot

        plt = matplotlib.pyplot
    if Figure is None:
        from matplotlib.figure import Figure as figure_class

        Figure = figure_class
    if FigureCanvasTkAgg is None or NavigationToolbar2Tk is None:
        from matplotlib.backends import backend_tkagg

        if FigureCanvasTkAgg is None:
            FigureCanvasTkAgg = backend_tkagg.FigureCanvasTkAgg
        if NavigationToolbar2Tk is None:
            NavigationToolbar2Tk = backend_tkagg.NavigationToolbar2Tk


def _maybe_switch_matplotlib_backend_to_tkagg() -> None:
    _load_toolkits()
    backend = plt.get_backend().lower()
    if 'tkagg' not in backend:
        try:
            plt.switch_backend('TkAgg')
        except Exception:  # pragma: no cover - depends on environment
            pass


def run_gui(file_path: str | None = None, *, device=None) -> None:
    """
    Launch the GUI, optionally opening a FITS file immediately. See also
    :func:`Observation.run_gui` to interactively fit an existing
    observation. ``device``: where the observations opened run (default:
    the card; ``'cpu'`` for the CPU).
    """
    _run_gui_from_cli(file_path, device=device)


def _run_gui_from_cli(file_path: str | None, *, device=None) -> None:
    _maybe_switch_matplotlib_backend_to_tkagg()
    gui = GUI(device=device)
    if file_path is not None:
        gui.set_observation(Observation(file_path, device=device))
    gui.run()


class Quit(Exception):
    """Raised internally to exit the main loop."""


class CancelSave(Exception):
    """Raised from the progress hook to abort an in-progress save."""


class GUI:
    """
    Main planetmapper_tpu_torch user interface window.

    Keyboard shortcuts match the reference: arrows/WASD pan the disc,
    ``+``/``-`` resize, ``<``/``>`` (or ``,``/``.``) rotate, ``[``/``]``
    change the step size, ``Ctrl-O``/``Ctrl-S`` open/save, ``c``/``C``
    copy the clicked coordinates (machine/formatted), ``Ctrl-H`` shows
    the FITS header and ``Ctrl-P`` the spectrum popup.

    ``device``: where observations opened through the GUI run (default: the
    card). An observation given to :meth:`set_observation` keeps its own.
    """

    def __init__(self, allow_open: bool = True, *, device=None) -> None:
        self.allow_open = allow_open
        self.device = device
        self.observation: Observation | None = None
        self.step_size = 1.0
        self.plot_settings: dict[PlotKey, dict[str, Any]] = {
            k: dict(v) for k, v in DEFAULT_PLOT_SETTINGS.items()
        }
        self.root: tk.Tk | None = None
        self.last_click_location: tuple[float, float] | None = None
        self.click_locations: list[tuple[float, float]] = []
        self.coords_machine_str = ''
        self.coords_formatted_str = ''
        self.plot_handles: dict[PlotKey, list] = defaultdict(list)
        self._plot_background: tuple | None = None
        self._popups: list[Any] = []
        self._delayed_actions: dict[str, str] = {}
        self.disc_method_message: str = ''
        self._spectrum_popup = None
        self._image_handle = None
        self.wireframe_transform = None

        self.shortcuts: dict[Callable[[], Any], list[str]] = {
            self.increase_step: [']'],
            self.decrease_step: ['['],
            self.move_up: ['<Up>', 'w'],
            self.move_down: ['<Down>', 's'],
            self.move_right: ['<Right>', 'd'],
            self.move_left: ['<Left>', 'a'],
            self.rotate_right: ['>', '.'],
            self.rotate_left: ['<less>', ','],
            self.increase_radius: ['+', '='],
            self.decrease_radius: ['-', '_'],
            self.save_button: ['<Control-s>'],
            self.load_observation: ['<Control-o>'],
            self.copy_machine_coord_values: ['c'],
            self.copy_formatted_coord_values: ['<Shift-C>'],
            self.display_header: ['<Control-h>'],
            self.display_spectrum_popup: ['<Control-p>'],
        }
        self.shortcuts_to_keep_in_entry = ['<Control-s>', '<Control-o>']

        self.setter_callbacks: defaultdict[
            SetterKey, list[Callable[[float], Any]]
        ] = defaultdict(
            list,
            {
                'x0': [lambda f: self.get_observation().set_x0(f)],
                'y0': [lambda f: self.get_observation().set_y0(f)],
                'r0': [lambda f: self.get_observation().set_r0(f)],
                'rotation': [
                    lambda f: self.get_observation().set_rotation(f)
                ],
                'step': [self.set_step],
            },
        )
        self.ui_callbacks: defaultdict[
            SetterKey, set[Callable[[], Any]]
        ] = defaultdict(set)

        self._build_disc_finding_registry()

    def __repr__(self) -> str:
        return f'<planetmapper_tpu_torch.gui.GUI object at {hex(id(self))}>'

    # ------------------------------------------------------------------
    # Disc finding routine registry
    # ------------------------------------------------------------------
    def _build_disc_finding_registry(self) -> None:
        """
        Sections of (callback, label, tooltip, requirement) rows;
        ``requirement`` gates button availability per observation
        ('header' / 'wcs' / 'gradient' / None).
        """
        obs = self.get_observation
        self.disc_finding_routines: dict[
            str, list[tuple[Callable[[], Any], str, str, str | None]]
        ] = {
            'Reset disc': [
                (
                    lambda: (
                        obs().reset_disc_params(),
                        self.update_disc_param_source_message(),
                    ),
                    'Reset all disc parameters',
                    'Reset the disc parameters to their initial values',
                    None,
                ),
                (
                    lambda: obs().centre_disc(),
                    'Centre disc in image',
                    "Centre the target's planetary disc and make it fill "
                    '~90% of the observation',
                    None,
                ),
                (
                    lambda: obs().rotate_north_to_top(),
                    'Rotate north to top',
                    'Rotate the disc so that the north pole of the target '
                    'is at the top of the image',
                    None,
                ),
            ],
            'Use FITS header metadata': [
                (
                    lambda: obs().disc_from_header(),
                    'Use PlanetMapper metadata',
                    "Set disc parameters using information in the "
                    "observation's FITS header generated by previous runs",
                    'header',
                ),
            ],
            'Use WCS data from FITS header': [
                (
                    lambda: obs().disc_from_wcs(
                        suppress_warnings=True, validate=False,
                        use_header_offsets=False,
                    ),
                    'Use WCS position, rotation & scale',
                    'Set all disc parameters using approximate WCS '
                    "information in the observation's FITS header",
                    'wcs',
                ),
                (
                    lambda: obs().position_from_wcs(
                        suppress_warnings=True, validate=False,
                        use_header_offsets=False,
                    ),
                    'Use WCS position',
                    'Set disc position using approximate WCS information',
                    'wcs',
                ),
                (
                    lambda: obs().rotation_from_wcs(
                        suppress_warnings=True, validate=False,
                        use_header_offsets=False,
                    ),
                    'Use WCS rotation',
                    'Set disc rotation using approximate WCS information',
                    'wcs',
                ),
                (
                    lambda: obs().plate_scale_from_wcs(
                        suppress_warnings=True, validate=False,
                        use_header_offsets=False,
                    ),
                    'Use WCS plate scale',
                    'Set plate scale using approximate WCS information',
                    'wcs',
                ),
            ],
            'Fit observation': [
                (
                    lambda: obs().fit_disc_position(),
                    'Fit disc position',
                    "Set x0 and y0 so that the planet's disc is fit to the "
                    'brightest part of the data',
                    None,
                ),
                (
                    lambda: obs().fit_disc_radius(),
                    'Fit disc radius',
                    'Set r0 by calculating the radius around (x0, y0) where '
                    'the brightness decrease is the fastest',
                    None,
                ),
                (
                    lambda: self._run_gradient_fit(),
                    'Fit disc (gradient descent)',
                    'Fit all disc parameters by differentiable rendering '
                    '(gradient descent on the observation\'s device, the card '
                    'by default)',
                    None,
                ),
            ],
        }

    def _run_gradient_fit(self) -> None:
        from .parallel.fit import fit_disc_gradient

        fit_disc_gradient(self.get_observation())

    def make_disc_finding_fn(
        self, fn: Callable[[], Any]
    ) -> Callable[[], None]:
        def button_command() -> None:
            try:
                fn()
            except Exception as exc:
                traceback.print_exc()
                _load_toolkits()
                messagebox.showwarning(
                    'Disc finding failed', str(exc)
                )
                return
            self.update_disc_param_source_message()
            self.run_all_ui_callbacks()

        return button_command

    # ------------------------------------------------------------------
    # Observation management
    # ------------------------------------------------------------------
    def load_observation(self) -> None:
        if not self.allow_open:
            return
        from ._gui_popups import OpenObservation

        OpenObservation(self, first_run=self.observation is None)

    def set_observation(self, observation: Observation) -> None:
        """Set the observation to fit (modified in place by the GUI)."""
        self.observation = observation
        self.last_click_location = None
        self.click_locations = []
        # Reset the per-cube image indices if out of range
        misc = self.plot_settings['_']
        nz = observation.data.shape[0]
        for k in ('image_idx_single', 'image_idx_r', 'image_idx_g',
                  'image_idx_b'):
            if misc.get(k, 0) >= nz:
                misc[k] = 0
        if self.root is not None:
            self.after_setting_observation()

    def after_setting_observation(self) -> None:
        self.update_disc_param_source_message()
        self.enable_observation_dependant_buttons()
        self.rebuild_plot()
        self.run_all_ui_callbacks()
        self.update_coords()

    def get_observation(self) -> Observation:
        if self.observation is None:
            raise ValueError('No observation loaded')
        return self.observation

    def update_disc_param_source_message(self) -> None:
        obs = self.observation
        if obs is None:
            return
        method = obs.get_disc_method()
        self.set_disc_method_message(f'Disc method: {method}')

    def set_disc_method_message(
        self, msg: str, *, color: str = 'black'
    ) -> None:
        self.disc_method_message = msg
        label = getattr(self, '_disc_method_label', None)
        if label is not None:
            label.configure(text=self._x11(msg), foreground=color)

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------
    def run(self) -> None:
        """Build the interface and enter the tk main loop."""
        if self.observation is None and not self.allow_open:
            raise ValueError('No observation to run GUI with')
        _maybe_switch_matplotlib_backend_to_tkagg()
        self.root = tk.Tk()
        self.root.title(f'planetmapper_tpu_torch {common.__version__}')
        self.set_icon(self.root)
        self.configure_style(self.root)
        self.build_gui()
        if self.observation is None:
            self.root.after(50, self.load_observation)
        else:
            self.after_setting_observation()
        try:
            self.root.mainloop()
        except Quit:
            pass

    def quit(self) -> None:
        self.close_all_popups()
        if self.root is not None:
            self.root.destroy()
            self.root = None

    close = quit  # legacy alias

    def set_icon(self, root: tk.Tk) -> None:
        try:
            from ._assets import get_gui_icon_path

            icon_path = get_gui_icon_path()
            if os.path.exists(icon_path):
                root.iconphoto(True, tk.PhotoImage(file=icon_path))
        except Exception:
            pass

    def configure_style(self, root: tk.Tk | None) -> None:
        try:
            style = ttk.Style(root)
            if sys.platform == 'linux' and 'clam' in style.theme_names():
                style.theme_use('clam')
        except Exception:
            pass

    def _x11(self, s: str) -> str:
        if _use_x11_font_bugfix():
            for a, b in _X11_FONT_TRANSLATIONS.items():
                s = s.replace(a, b)
        return s

    # ------------------------------------------------------------------
    # Widget construction
    # ------------------------------------------------------------------
    def build_gui(self) -> None:
        assert self.root is not None
        _load_toolkits()
        root = self.root
        self.hint_frame = ttk.Frame(root)
        self.hint_frame.pack(side='bottom', fill='x')
        self.build_help_hint()

        panel = ttk.Frame(root)
        panel.pack(side='left', fill='y')
        self.build_top_controls(panel)
        self.build_controls(panel)

        plot_frame = ttk.Frame(root)
        plot_frame.pack(side='right', fill='both', expand=True)
        self.build_plot(plot_frame)
        self.bind_keyboard()

    def build_top_controls(self, parent: ttk.Frame) -> None:
        bar = ttk.Frame(parent)
        bar.pack(fill='x', padx=4, pady=4)
        if self.allow_open:
            ttk.Button(
                bar, text='Open...', command=self.load_observation, width=8
            ).pack(side='left', padx=2)
        ttk.Button(
            bar, text='Save...', command=self.save_button, width=8
        ).pack(side='left', padx=2)
        ttk.Button(
            bar, text='Header...', command=self.display_header, width=8
        ).pack(side='left', padx=2)

    def build_controls(self, parent: ttk.Frame) -> None:
        self.notebook = ttk.Notebook(parent)
        self.notebook.pack(fill='both', expand=True, padx=4, pady=4)
        self.build_main_controls_tab()
        self.build_plot_settings_controls_tab()
        self.build_disc_finding_controls_tab()
        self.build_coords_tab()
        self.build_help_tab()

    # -- controls tab ---------------------------------------------------
    def build_main_controls_tab(self) -> None:
        tab = ttk.Frame(self.notebook)
        self.notebook.add(tab, text='Controls')

        frame = ttk.LabelFrame(tab, text='Disc parameters')
        frame.pack(fill='x', padx=4, pady=4)
        self.numeric_entries: dict[SetterKey, '_NumericEntry'] = {}
        for key, label in (
            ('x0', 'x0 (px)'), ('y0', 'y0 (px)'), ('r0', 'r0 (px)'),
            ('rotation', 'rotation (°)'),
        ):
            self.numeric_entries[key] = _NumericEntry(self, frame, key, label)
        step_frame = ttk.LabelFrame(tab, text='Step size')
        step_frame.pack(fill='x', padx=4, pady=4)
        self.numeric_entries['step'] = _NumericEntry(
            self, step_frame, 'step', 'step',
            get_value=lambda: self.step_size,
        )

        self._disc_method_label = ttk.Label(tab, text='')
        self._disc_method_label.pack(fill='x', padx=4)
        self.update_disc_param_source_message()

        wcs_frame = ttk.LabelFrame(tab, text='WCS offsets')
        wcs_frame.pack(fill='x', padx=4, pady=4)
        self.build_wcs_offset_section(wcs_frame)

    # -- WCS offsets ------------------------------------------------------
    def _get_wcs_offsets(self) -> tuple[float, float, float, float]:
        """(dra_arcsec, ddec_arcsec, dr0, drotation) vs the WCS solution."""
        obs = self.get_observation()
        dra, ddec, dr0, drotation = obs._get_wcs_offsets_for_arcsec(
            suppress_warnings=True, validate=False, use_header_offsets=False
        )
        drotation = (drotation + 180.0) % 360.0 - 180.0
        return dra, ddec, dr0, drotation

    def _set_wcs_offsets(
        self, *, dra_arcsec: float | None = None,
        ddec_arcsec: float | None = None, dr0: float | None = None,
        drotation: float | None = None,
    ) -> None:
        """Nudge the disc to the given offsets from the WCS solution."""
        obs = self.get_observation()
        x0w, y0w, r0w, rotw = obs._get_disc_params_from_wcs(
            suppress_warnings=True, validate=False, use_header_offsets=False
        )
        if dra_arcsec is not None or ddec_arcsec is not None:
            current = self._get_wcs_offsets()
            dra = current[0] if dra_arcsec is None else dra_arcsec
            ddec = current[1] if ddec_arcsec is None else ddec_arcsec
            ra0, dec0 = obs.xy2radec(x0w, y0w)
            x0, y0 = obs.radec2xy(
                ra0 + dra / 3600.0, dec0 + ddec / 3600.0
            )
            obs.set_x0(float(x0))
            obs.set_y0(float(y0))
        if dr0 is not None:
            obs.set_r0(r0w + dr0)
        if drotation is not None:
            obs.set_rotation(rotw + drotation)

    def build_wcs_offset_section(self, frame: ttk.LabelFrame) -> None:
        self._wcs_offset_vars: dict[str, tk.StringVar] = {}
        for key, text in (
            ('dra', 'ΔRA (arcsec)'), ('ddec', 'ΔDec (arcsec)'),
            ('dr0', 'Δr0 (px)'), ('drotation', 'Δrotation (°)'),
        ):
            row = ttk.Frame(frame)
            row.pack(fill='x')
            ttk.Label(row, text=self._x11(text), width=14).pack(side='left')
            var = tk.StringVar()
            entry = ttk.Entry(row, textvariable=var, width=12)
            entry.pack(side='left')
            entry.bind(
                '<Return>', lambda e, k=key: self._wcs_offset_entered(k)
            )
            self._wcs_offset_vars[key] = var
        self.add_tooltip(
            frame,
            'Offsets of the current disc from the WCS solution; type a '
            'value and press Enter to apply',
        )
        for key in ('x0', 'y0', 'r0', 'rotation'):
            self.ui_callbacks[key].add(self.update_wcs_offset_labels)

    def _wcs_offset_entered(self, key: str) -> None:
        try:
            value = float(self._wcs_offset_vars[key].get())
        except ValueError:
            self.update_wcs_offset_labels()
            return
        kwargs = {
            'dra': dict(dra_arcsec=value),
            'ddec': dict(ddec_arcsec=value),
            'dr0': dict(dr0=value),
            'drotation': dict(drotation=value),
        }[key]
        try:
            self._set_wcs_offsets(**kwargs)
        except Exception as exc:
            _load_toolkits()
            messagebox.showwarning('WCS offset failed', str(exc))
            return
        self.run_all_ui_callbacks()

    def update_wcs_offset_labels(self) -> None:
        if self.observation is None:
            return
        try:
            dra, ddec, dr0, drotation = self._get_wcs_offsets()
            values = {
                'dra': f'{dra:+.6g}', 'ddec': f'{ddec:+.6g}',
                'dr0': f'{dr0:+.6g}', 'drotation': f'{drotation:+.6g}',
            }
        except Exception:
            values = {
                k: 'n/a' for k in ('dra', 'ddec', 'dr0', 'drotation')
            }
        for k, var in self._wcs_offset_vars.items():
            var.set(values.get(k, ''))

    # -- plot settings tab ----------------------------------------------
    def build_plot_settings_controls_tab(self) -> None:
        from ._gui_settings import build_plot_settings_rows

        tab = ttk.Frame(self.notebook)
        self.notebook.add(tab, text='Plot settings')
        build_plot_settings_rows(self, tab)

    # -- disc finding tab -------------------------------------------------
    def build_disc_finding_controls_tab(self) -> None:
        tab = ttk.Frame(self.notebook)
        self.notebook.add(tab, text='Disc finding')
        self._disc_finding_buttons: dict[str | None, list[ttk.Button]] = (
            defaultdict(list)
        )
        for section, rows in self.disc_finding_routines.items():
            frame = ttk.LabelFrame(tab, text=section)
            frame.pack(fill='x', padx=4, pady=4)
            for fn, label, tooltip, requirement in rows:
                button = ttk.Button(
                    frame, text=label, command=self.make_disc_finding_fn(fn)
                )
                button.pack(fill='x', padx=2, pady=1)
                self.add_tooltip(button, tooltip)
                self._disc_finding_buttons[requirement].append(button)

    def enable_observation_dependant_buttons(self) -> None:
        self.enable_disc_finding_buttons()

    def enable_disc_finding_buttons(self) -> None:
        obs = self.observation
        if obs is None:
            return
        available: dict[str | None, bool] = {None: True}
        available['header'] = bool(
            getattr(obs, 'header', None)
            and any(
                k.startswith('HIERARCH PLANMAP') or k.startswith('PLANMAP')
                for k in obs.header
            )
        )
        try:
            obs._get_wcs_from_header(suppress_warnings=True)
            available['wcs'] = True
        except Exception:
            available['wcs'] = False
        for requirement, buttons in self._disc_finding_buttons.items():
            state = 'normal' if available.get(requirement, True) else 'disabled'
            for button in buttons:
                button.configure(state=state)

    # -- coords tab -------------------------------------------------------
    #: Grouped readout rows: {section: [(key, label, tooltip), ...]}
    coords_labels: dict[str, list[tuple[str, str, str]]] = {
        'Pixel coordinates': [
            ('x', 'x', 'Pixel x coordinate of the clicked location'),
            ('y', 'y', 'Pixel y coordinate of the clicked location'),
        ],
        'Celestial coordinates': [
            ('ra', 'RA', 'Right ascension (J2000)'),
            ('dec', 'Dec', 'Declination (J2000)'),
        ],
        'Planetographic coordinates': [
            ('lon', 'Lon', 'Planetographic longitude'),
            ('lat', 'Lat', 'Planetographic latitude'),
        ],
        'Planetocentric coordinates': [
            ('lon_centric', 'Lon', 'Planetocentric longitude'),
            ('lat_centric', 'Lat', 'Planetocentric latitude'),
        ],
        'Illumination angles': [
            ('phase', 'Phase', 'Phase angle'),
            ('incidence', 'Incidence', 'Incidence angle'),
            ('emission', 'Emission', 'Emission angle'),
            ('azimuth', 'Azimuth', 'Azimuth angle'),
        ],
        'Distances': [
            ('limb_distance', 'Limb', 'Distance above the limb'),
            ('ring_radius', 'Ring', 'Ring plane radius'),
        ],
    }

    def build_coords_tab(self) -> None:
        tab = ttk.Frame(self.notebook)
        self.notebook.add(tab, text='Coords')
        self.coords_tab_labels: dict[str, ttk.Label] = {}
        for section, rows in self.coords_labels.items():
            frame = ttk.LabelFrame(tab, text=section)
            frame.pack(fill='x', padx=4, pady=2)
            for key, label, tooltip in rows:
                row = ttk.Frame(frame)
                row.pack(fill='x')
                name = ttk.Label(row, text=label, width=10)
                name.pack(side='left')
                self.add_tooltip(name, tooltip)
                value = ttk.Label(row, text='')
                value.pack(side='left')
                self.coords_tab_labels[key] = value
        bar = ttk.Frame(tab)
        bar.pack(fill='x', pady=4)
        ttk.Button(
            bar, text='Copy values (c)',
            command=self.copy_machine_coord_values,
        ).pack(side='left', padx=2)
        ttk.Button(
            bar, text='Copy formatted (C)',
            command=self.copy_formatted_coord_values,
        ).pack(side='left', padx=2)
        ttk.Button(
            bar, text='Spectrum... (Ctrl-P)',
            command=self.display_spectrum_popup,
        ).pack(side='left', padx=2)

    # -- help tab --------------------------------------------------------
    HELP_TEXT = '\n'.join(
        [
            'planetmapper_tpu_torch - fit planetary observations '
            'interactively.',
            '',
            'Keyboard shortcuts:',
            '  Arrows / WASD : move the disc',
            '  + / -         : increase / decrease the disc radius',
            '  < / > (, / .) : rotate the disc',
            '  [ / ]         : decrease / increase the step size',
            '  Ctrl-O        : open an observation',
            '  Ctrl-S        : save the navigated observation',
            '  Ctrl-H        : show the FITS header',
            '  Ctrl-P        : show the spectrum popup (for cubes)',
            '  c / C         : copy clicked coords (machine / formatted)',
            '',
            'Click the plot to read off coordinates and backplane values',
            'at that pixel (shown in the Coords tab).',
            '',
            'The "Disc finding" tab sets the disc parameters from FITS',
            'metadata, WCS information, or by fitting the data; fine-tune',
            'with the keyboard or the Controls tab entries.',
            '',
            f'Documentation: {common.__url__}',
            f'Citation: {common.CITATION_STRING}',
        ]
    )

    def build_help_tab(self) -> None:
        tab = ttk.Frame(self.notebook)
        self.notebook.add(tab, text='Help')
        text = tk.Text(tab, wrap='word', width=40, height=30)
        text.insert('1.0', self._x11(self.HELP_TEXT))
        text.configure(state='disabled')
        text.pack(fill='both', expand=True, padx=4, pady=4)

    # -- help hint / tooltips ----------------------------------------------
    DEFAULT_HINT = (
        'Arrows: move | +/-: resize | </>: rotate | [/]: step | '
        'click: read coordinates'
    )

    def build_help_hint(self) -> None:
        self.help_hint = ttk.Label(self.hint_frame, text='')
        self.help_hint.pack(side='left', padx=4)
        self.reset_help_hint()

    def set_help_hint(self, msg: str, *, hover: bool = False) -> None:
        if getattr(self, 'help_hint', None) is not None:
            self.help_hint.configure(text=self._x11(msg))

    def reset_help_hint(self, *, hover: bool = False) -> None:
        self.set_help_hint(self.DEFAULT_HINT, hover=hover)

    def add_tooltip(self, widget: tk.Widget, msg: str) -> None:
        widget.bind('<Enter>', lambda e: self.set_help_hint(msg, hover=True))
        widget.bind('<Leave>', lambda e: self.reset_help_hint(hover=True))

    # ------------------------------------------------------------------
    # Keyboard
    # ------------------------------------------------------------------
    def bind_keyboard(self) -> None:
        assert self.root is not None
        for fn, keys in self.shortcuts.items():
            for key in keys:
                self.root.bind(key, self._make_keypress_handler(fn))

    def _make_keypress_handler(self, fn: Callable[[], Any]):
        def handler(event) -> None:
            widget = event.widget
            # Keep plain-character shortcuts usable inside text entries
            if isinstance(widget, (tk.Entry, ttk.Entry, tk.Text)):
                keysym = f'<{event.keysym}>'
                combo = (
                    f'<Control-{event.keysym}>'
                    if event.state & 0x4 else keysym
                )
                if combo not in self.shortcuts_to_keep_in_entry:
                    return
            self.process_keypress(event, fn)

        return handler

    def process_keypress(self, event, fn: Callable[[], Any]) -> None:
        if self.observation is None:
            return
        try:
            fn()
        except Exception:
            traceback.print_exc()

    # -- value setters ----------------------------------------------------
    def run_all_ui_callbacks(self, update_plot: bool = True) -> None:
        for callbacks in self.ui_callbacks.values():
            for callback in list(callbacks):
                callback()
        if update_plot:
            self.update_plot_transforms()
            self.update_coords()

    def set_value(
        self, key: SetterKey, value: float, update_plot: bool = True
    ) -> None:
        for setter in self.setter_callbacks[key]:
            setter(value)
        for callback in list(self.ui_callbacks[key]):
            callback()
        if update_plot and key != 'step':
            self.update_plot_transforms()
            self.update_coords()

    def set_step(self, step: float) -> None:
        if step <= 0 or not np.isfinite(step):
            raise ValueError('step must be positive and finite')
        self.step_size = float(step)

    def increase_step(self) -> None:
        self.set_value('step', self.step_size * 10)

    def decrease_step(self) -> None:
        self.set_value('step', self.step_size / 10)

    def _adjust(self, **kwargs: float) -> None:
        obs = self.get_observation()
        obs.adjust_disc_params(**kwargs)
        self.run_all_ui_callbacks()

    def move_up(self) -> None:
        self._adjust(dy=self.step_size)

    def move_down(self) -> None:
        self._adjust(dy=-self.step_size)

    def move_left(self) -> None:
        self._adjust(dx=-self.step_size)

    def move_right(self) -> None:
        self._adjust(dx=self.step_size)

    def move_up_left(self) -> None:
        self._adjust(dx=-self.step_size, dy=self.step_size)

    def move_up_right(self) -> None:
        self._adjust(dx=self.step_size, dy=self.step_size)

    def move_down_left(self) -> None:
        self._adjust(dx=-self.step_size, dy=-self.step_size)

    def move_down_right(self) -> None:
        self._adjust(dx=self.step_size, dy=-self.step_size)

    def rotate_left(self) -> None:
        self._adjust(drotation=-self.step_size)

    def rotate_right(self) -> None:
        self._adjust(drotation=self.step_size)

    def increase_radius(self) -> None:
        self._adjust(dr=self.step_size)

    def decrease_radius(self) -> None:
        try:
            self._adjust(dr=-self.step_size)
        except ValueError:
            pass  # r0 must stay positive

    def save_button(self) -> None:
        if self.observation is None:
            return
        from ._gui_popups import SaveObservation

        SaveObservation(self)

    def display_header(self) -> None:
        if self.observation is None:
            return
        from ._gui_popups import HeaderDisplay

        HeaderDisplay(self)

    def display_spectrum_popup(self) -> None:
        if self.observation is None:
            return
        from ._gui_popups import SpectrumPopup

        if self._spectrum_popup is None or not self._spectrum_popup.is_open:
            self._spectrum_popup = SpectrumPopup(self)
        else:
            self._spectrum_popup.give_focus()

    def maybe_update_spectrum_popup(self) -> None:
        popup = self._spectrum_popup
        if popup is not None and popup.is_open:
            popup.update()

    # ------------------------------------------------------------------
    # Popup registry
    # ------------------------------------------------------------------
    def add_popup(self, popup) -> None:
        self._popups.append(popup)

    def remove_popup(self, popup) -> None:
        if popup in self._popups:
            self._popups.remove(popup)

    def get_popups(self) -> list:
        return list(self._popups)

    def close_all_popups(self, *, keep_open: list | None = None) -> None:
        keep_open = keep_open or []
        for popup in self.get_popups():
            if popup not in keep_open:
                popup.close_window()

    # ------------------------------------------------------------------
    # Click handling & coordinate readout
    # ------------------------------------------------------------------
    def figure_click_callback(self, event) -> None:
        if not event.inaxes or getattr(event, 'dblclick', False):
            return
        try:
            if getattr(self, 'toolbar', None) and self.toolbar.mode != '':
                return  # panning/zooming
        except Exception:
            pass
        if event.xdata is None or event.ydata is None:
            return
        self.set_click_location(float(event.xdata), float(event.ydata))

    def set_click_location(self, x: float, y: float) -> None:
        self.last_click_location = (x, y)
        self.click_locations.append((x, y))
        self.update_coords(print_coords=True)
        self.replot_marked_coord()
        self.draw_plot_animated_artists()

    def clear_click_location(self) -> None:
        self.last_click_location = None
        self.update_coords()
        self.replot_marked_coord()

    def get_click_coords(self) -> dict[str, float]:
        if self.last_click_location is None:
            return {}
        return self._get_coords_for_location(*self.last_click_location)

    def _get_coords_for_location(
        self, x: float, y: float
    ) -> dict[str, float]:
        out: dict[str, float] = {}
        obs = self.get_observation()
        ra, dec = obs.xy2radec(x, y)
        out['x'] = x
        out['y'] = y
        out['ra'] = float(ra)
        out['dec'] = float(dec)
        _, _, out['limb_distance'] = obs.limb_coordinates_from_radec(ra, dec)
        ring_radius, _, _ = obs.ring_plane_coordinates(ra, dec)
        if np.isfinite(ring_radius):
            out['ring_radius'] = float(ring_radius)
        try:
            targvec = obs._xy2targvec(x, y)
            out['lon'], out['lat'] = obs.targvec2lonlat(targvec)
            out['lon_centric'], out['lat_centric'] = (
                obs._targvec2lonlat_centric(targvec)
            )
            phase, incdnc, emissn = (
                obs._illumination_angles_from_targvec_radians(targvec)
            )
            az = obs._azimuth_angle_from_gie_radians(phase, incdnc, emissn)
            out['phase'], out['incidence'], out['emission'], out['azimuth'] = (
                np.rad2deg((phase, incdnc, emissn, az))
            )
        except NotFoundError:
            pass
        return out

    def update_coords(self, print_coords: bool = False) -> None:
        self.maybe_update_spectrum_popup()
        labels = getattr(self, 'coords_tab_labels', None)
        if self.last_click_location is None:
            if labels:
                for label in labels.values():
                    label.configure(text='')
            return
        coords = self.get_click_coords()
        coords_strs = self.get_click_coords_formatted_strings(coords)
        if print_coords:
            # Trailing comma so lines can be pasted straight into a list
            print(self.make_click_json_string(coords) + ',')
        self.coords_machine_str = self.make_click_json_string(
            coords, fmt='', fmt_radec=''
        )
        self.coords_formatted_str = self.make_click_formatted_string(
            coords_strs
        )
        if labels:
            for key, label in labels.items():
                label.configure(text=self._x11(coords_strs.get(key, '')))

    def get_click_coords_formatted_strings(
        self, coords: dict[str, float], fmt: str = '.2f',
        dms_fmt: str = '.3f',
    ) -> dict[str, str]:
        out: dict[str, str] = {}
        obs = self.get_observation()
        out['x'] = f'{coords["x"]:{fmt}}'
        out['y'] = f'{coords["y"]:{fmt}}'
        out['ra'] = utils.decimal_degrees_to_dms_str(coords['ra'], dms_fmt)
        out['dec'] = utils.decimal_degrees_to_dms_str(coords['dec'], dms_fmt)

        def distance_str(value: float) -> str:
            return f'{value:_.0f} km'.replace('_', ' ')

        out['limb_distance'] = distance_str(coords['limb_distance'])
        if 'ring_radius' in coords:
            out['ring_radius'] = distance_str(coords['ring_radius'])
        if 'lon' in coords:
            ew = obs.positive_longitude_direction
            lat = coords['lat']
            out['lon'] = f'{coords["lon"]:{fmt}}°{ew}'
            out['lat'] = f'{abs(lat):{fmt}}°{"N" if lat >= 0 else "S"}'
            lat_c = coords['lat_centric']
            out['lon_centric'] = f'{coords["lon_centric"]:{fmt}}°E'
            out['lat_centric'] = (
                f'{abs(lat_c):{fmt}}°{"N" if lat >= 0 else "S"}'
            )
            for k in ('phase', 'incidence', 'emission', 'azimuth'):
                out[k] = f'{coords[k]:{fmt}}°'
        return out

    def make_click_formatted_string(
        self, coords_strs: dict[str, str]
    ) -> str:
        msg = []
        for name, rows in self.coords_labels.items():
            msg.append(name)
            for key, label, _tooltip in rows:
                msg.append(f'  - {label}: {coords_strs.get(key, "")}')
        return '\n'.join(msg)

    def make_click_json_string(
        self, coords: dict[str, float], fmt: str = '.2f',
        fmt_radec: str = '.6f',
    ) -> str:
        parts = [
            f'"xy": [{coords["x"]:{fmt}}, {coords["y"]:{fmt}}]',
            f'"radec": [{coords["ra"]:{fmt_radec}}, '
            f'{coords["dec"]:{fmt_radec}}]',
        ]
        if 'lon' in coords:
            parts.extend(
                [
                    f'"lonlat": [{coords["lon"]:{fmt}}, '
                    f'{coords["lat"]:{fmt}}]',
                    f'"lonlat_centric": [{coords["lon_centric"]:{fmt}}, '
                    f'{coords["lat_centric"]:{fmt}}]',
                    f'"phase": {coords["phase"]:{fmt}}',
                    f'"incidence": {coords["incidence"]:{fmt}}',
                    f'"emission": {coords["emission"]:{fmt}}',
                    f'"azimuth": {coords["azimuth"]:{fmt}}',
                ]
            )
        parts.append(f'"limb_distance": {coords["limb_distance"]:{fmt}}')
        if 'ring_radius' in coords:
            parts.append(f'"ring_radius": {coords["ring_radius"]:{fmt}}')
        return '{' + ', '.join(parts) + '}'

    def copy_machine_coord_values(self) -> None:
        self.copy_to_clipboard(self.coords_machine_str)

    def copy_formatted_coord_values(self) -> None:
        self.copy_to_clipboard(self.coords_formatted_str)

    def copy_to_clipboard(self, s: str) -> None:
        if self.root is None:
            return
        self.root.clipboard_clear()
        self.root.clipboard_append(s)

    # ------------------------------------------------------------------
    # Image display modes
    # ------------------------------------------------------------------
    def image_sum(self) -> np.ndarray:
        return np.nansum(self.get_observation().data, axis=0)

    def image_single(self) -> np.ndarray:
        idx = int(self.plot_settings['_']['image_idx_single'])
        return self.get_observation().data[idx]

    def image_rgb(self) -> np.ndarray:
        misc = self.plot_settings['_']
        data = self.get_observation().data
        channels = [
            data[int(misc[f'image_idx_{c}'])] for c in ('r', 'g', 'b')
        ]
        rgb = np.stack(channels, axis=-1)
        with np.errstate(invalid='ignore'):
            rgb = utils.normalise(np.nan_to_num(rgb))
        return rgb

    def get_image(self) -> np.ndarray:
        mode = self.plot_settings['_'].get('image_mode', 'single')
        if self.get_observation().data.shape[0] == 1:
            mode = 'single'
        img = {
            'sum': self.image_sum,
            'single': self.image_single,
            'rgb': self.image_rgb,
        }.get(mode, self.image_single)()
        gamma = float(self.plot_settings['_'].get('image_gamma', 1) or 1)
        if gamma != 1:
            with np.errstate(invalid='ignore'):
                img = np.power(utils.normalise(img), 1.0 / gamma)
        return img

    def get_image_limits(self, img: np.ndarray) -> tuple[float, float]:
        misc = self.plot_settings['_']
        vmin = float(misc.get('image_vmin', 0))
        vmax = float(misc.get('image_vmax', 100))
        limit_type = misc.get('image_limit_type', 'relative')
        finite = img[np.isfinite(img)]
        if finite.size == 0:
            return 0.0, 1.0
        if limit_type == 'absolute':
            return vmin, vmax
        if limit_type == 'percentile':
            return (
                float(np.percentile(finite, np.clip(vmin, 0, 100))),
                float(np.percentile(finite, np.clip(vmax, 0, 100))),
            )
        lo, hi = float(finite.min()), float(finite.max())
        return (
            lo + (hi - lo) * vmin / 100.0,
            lo + (hi - lo) * vmax / 100.0,
        )

    # ------------------------------------------------------------------
    # Plot engine (blitted wireframe over the image)
    # ------------------------------------------------------------------
    def build_plot(self, parent: ttk.Frame) -> None:
        self.figure = Figure(figsize=(6, 6))
        self.ax = self.figure.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.figure, master=parent)
        self.canvas.get_tk_widget().pack(fill='both', expand=True)
        try:
            self.toolbar = NavigationToolbar2Tk(self.canvas, parent)
        except Exception:
            self.toolbar = None
        self.canvas.mpl_connect(
            'button_press_event', self.figure_click_callback
        )
        self.canvas.mpl_connect('draw_event', self.on_plot_draw)

    def on_plot_draw(self, event=None) -> None:
        self.copy_plot_background()

    def copy_plot_background(self) -> None:
        try:
            self._plot_background = self.canvas.copy_from_bbox(
                self.figure.bbox
            )
        except Exception:
            self._plot_background = None

    def draw_plot_animated_artists(self) -> None:
        """Blit the animated wireframe artists over the cached background."""
        if self._plot_background is None:
            self.canvas.draw_idle()
            return
        try:
            self.canvas.restore_region(self._plot_background)
            for artists in self.plot_handles.values():
                for artist in artists:
                    self.ax.draw_artist(artist)
            self.canvas.blit(self.figure.bbox)
        except Exception:
            self.canvas.draw_idle()

    def rebuild_plot(self) -> None:
        """Full replot: image + wireframe (e.g. after loading a file)."""
        if self.observation is None:
            return
        self.ax.clear()
        self.plot_handles.clear()
        self._image_handle = None
        # Wireframe artists are drawn in RA/Dec coordinates through the
        # observation's *mutable* radec->xy transform: nudging the disc
        # only updates the transform and re-blits (no geometry recompute)
        self.wireframe_transform = (
            self.get_observation().matplotlib_radec2xy_transform(self.ax)
        )
        self.replot_image()
        self.replot_all()
        self.format_plot()
        self.canvas.draw()

    def replot_all(self) -> None:
        self.replot_limb()
        self.replot_terminator()
        self.replot_grid()
        self.replot_poles()
        self.replot_rings()
        self.replot_coordinates_lonlat()
        self.replot_coordinates_radec()
        self.replot_other_bodies()
        self.replot_marked_coord()

    def format_plot(self) -> None:
        obs = self.get_observation()
        nx, ny = obs.get_img_size()
        self.ax.set_xlim(-0.5, nx - 0.5)
        self.ax.set_ylim(-0.5, ny - 0.5)
        self.ax.set_aspect('equal', adjustable='box')
        self.ax.xaxis.set_visible(False)
        self.ax.yaxis.set_visible(False)

    def replot_image(self) -> None:
        obs = self.get_observation()
        img = self.get_image()
        settings = {
            k: v
            for k, v in self.plot_settings['image'].items()
            if k not in ('enabled',)
        }
        if img.ndim == 3:
            settings.pop('cmap', None)
            vmin = vmax = None
        else:
            vmin, vmax = self.get_image_limits(img)
        if self._image_handle is not None:
            try:
                self._image_handle.remove()
            except Exception:
                pass
        visible = self.plot_settings['image'].get('enabled', True)
        self._image_handle = self.ax.imshow(
            img, origin='lower', vmin=vmin, vmax=vmax, **settings
        )
        self._image_handle.set_visible(visible)

    def update_only_image(self) -> None:
        self.replot_image()
        self.canvas.draw_idle()

    def _component_settings(self, key: PlotKey) -> dict[str, Any]:
        return {
            k: v
            for k, v in self.plot_settings.get(key, {}).items()
            if k not in ('enabled', 'outline_color')
        }

    def _component_enabled(self, key: PlotKey) -> bool:
        return bool(self.plot_settings.get(key, {}).get('enabled', True))

    def remove_artists(self, key: PlotKey) -> None:
        for artist in self.plot_handles.pop(key, []):
            try:
                artist.remove()
            except Exception:
                pass

    def _add_lines(
        self, key: PlotKey, segments: list[np.ndarray], **extra
    ) -> None:
        self.remove_artists(key)
        if not self._component_enabled(key):
            return
        settings = self._component_settings(key) | extra
        transform = self.wireframe_transform
        for xy in segments:
            (line,) = self.ax.plot(
                xy[..., 0], xy[..., 1], animated=True,
                transform=transform, **settings,
            )
            self.plot_handles[key].append(line)

    def replot_limb(self) -> None:
        obs = self.get_observation()
        self._add_lines('limb', [np.stack(obs.limb_radec(), axis=-1)])
        self.remove_artists('limb_illuminated')
        if self._component_enabled('limb_illuminated'):
            settings = self._component_settings('limb_illuminated')
            ra_day, dec_day, _ra_night, _dec_night = (
                obs.limb_radec_by_illumination()
            )
            (line,) = self.ax.plot(
                ra_day, dec_day, animated=True,
                transform=self.wireframe_transform, **settings,
            )
            self.plot_handles['limb_illuminated'].append(line)

    def replot_terminator(self) -> None:
        obs = self.get_observation()
        self._add_lines(
            'terminator', [np.stack(obs.terminator_radec(), axis=-1)]
        )

    def replot_grid(self) -> None:
        obs = self.get_observation()
        misc = self.plot_settings['_']
        segments = [
            np.stack(grid, axis=-1)
            for grid in obs.visible_lonlat_grid_radec(
                interval=float(misc.get('grid_interval', 30)),
                lat_limit=float(misc.get('grid_lat_limit', 90)),
                planetocentric=bool(misc.get('grid_planetocentric', False)),
            )
        ]
        self._add_lines('grid', segments)

    def replot_poles(self) -> None:
        obs = self.get_observation()
        self.remove_artists('pole')
        if not self._component_enabled('pole'):
            return
        settings = self.plot_settings.get('pole', {})
        transform = self.wireframe_transform
        for lon, lat, label in ((0, 90, 'N'), (0, -90, 'S')):
            if not obs.test_if_lonlat_visible(lon, lat):
                continue
            x, y = obs.lonlat2radec(lon, lat)
            text = self.ax.annotate(
                label, (x, y), ha='center', va='center', weight='bold',
                color=settings.get('color', 'k'),
                path_effects=self._outline_effects(
                    settings.get('outline_color')
                ),
                animated=True, xycoords=transform,
            )
            self.plot_handles['pole'].append(text)

    @staticmethod
    def _outline_effects(outline_color):
        if not outline_color:
            return None
        import matplotlib.patheffects as path_effects

        return [
            path_effects.withStroke(linewidth=3, foreground=outline_color)
        ]

    def replot_rings(self) -> None:
        obs = self.get_observation()
        segments = []
        for radius in sorted(obs.ring_radii):
            try:
                ra, dec = obs.ring_radec(radius)
                segments.append(np.stack([ra, dec], axis=-1))
            except Exception:
                continue
        self._add_lines('ring', segments)

    def replot_coordinates_lonlat(self) -> None:
        self._replot_scatter(
            'coordinate_of_interest_lonlat',
            [
                self.get_observation().lonlat2radec(lon, lat)
                for lon, lat in (
                    self.get_observation().coordinates_of_interest_lonlat
                )
                if self.get_observation().test_if_lonlat_visible(lon, lat)
            ],
        )

    def replot_coordinates_radec(self) -> None:
        self._replot_scatter(
            'coordinate_of_interest_radec',
            list(self.get_observation().coordinates_of_interest_radec),
        )

    def _replot_scatter(
        self, key: PlotKey, points: list[tuple[float, float]]
    ) -> None:
        self.remove_artists(key)
        if not self._component_enabled(key) or not points:
            return
        settings = self._component_settings(key)
        color = settings.pop('color', None)
        if color is not None:
            settings['c'] = color
        transform = self.wireframe_transform
        xs, ys = zip(*points)
        handle = self.ax.scatter(
            xs, ys, animated=True, transform=transform, **settings
        )
        self.plot_handles[key].append(handle)

    def replot_other_bodies(self) -> None:
        obs = self.get_observation()
        self.remove_artists('other_body_of_interest_marker')
        self.remove_artists('other_body_of_interest_label')
        bodies = obs.other_bodies_of_interest
        if not bodies:
            return
        transform = self.wireframe_transform
        marker_on = self._component_enabled('other_body_of_interest_marker')
        label_on = self._component_enabled('other_body_of_interest_label')
        for body in bodies:
            x, y = body.target_ra, body.target_dec
            if marker_on:
                settings = self._component_settings(
                    'other_body_of_interest_marker'
                )
                settings['c'] = settings.pop('color', 'w')
                handle = self.ax.scatter(
                    [x], [y], animated=True, transform=transform, **settings
                )
                self.plot_handles['other_body_of_interest_marker'].append(
                    handle
                )
            if label_on:
                settings = self._component_settings(
                    'other_body_of_interest_label'
                )
                text = self.ax.annotate(
                    body.target, (x, y), ha='center', va='top',
                    xytext=(0, -5), textcoords='offset points',
                    animated=True, xycoords=transform, **settings,
                )
                self.plot_handles['other_body_of_interest_label'].append(
                    text
                )

    def replot_marked_coord(self) -> None:
        self.remove_artists('marked_coord')
        if (
            self.last_click_location is None
            or not self._component_enabled('marked_coord')
        ):
            return
        x, y = self.last_click_location
        settings = self._component_settings('marked_coord')
        for line in (
            self.ax.axhline(y, animated=True, **settings),
            self.ax.axvline(x, animated=True, **settings),
        ):
            self.plot_handles['marked_coord'].append(line)

    def update_plot_wireframe(self) -> None:
        """Recompute all wireframe geometry (e.g. after settings change)."""
        if self.observation is None or self.wireframe_transform is None:
            return
        self.replot_all()
        self.canvas.draw_idle()

    def update_plot_transforms(self) -> None:
        """
        Disc parameters changed: refresh the observation's mutable
        radec->xy transform (no geometry recomputation) and blit.
        """
        if self.observation is None or self.wireframe_transform is None:
            return
        self.get_observation().update_transform()
        self.draw_plot_animated_artists()


class _NumericEntry:
    """
    Labelled numeric entry bound to a GUI setter key: commits on Enter,
    reverts on invalid input, and stays in sync with external changes
    through the GUI's ui_callbacks registry.
    """

    def __init__(
        self, gui: GUI, parent: tk.Widget, key: SetterKey, label: str,
        get_value: Callable[[], float] | None = None,
    ) -> None:
        self.gui = gui
        self.key = key
        if get_value is None:
            def get_value() -> float:
                obs = gui.get_observation()
                return float(getattr(obs, f'get_{key}')())

        self.get_value = get_value
        row = ttk.Frame(parent)
        row.pack(fill='x', padx=2, pady=1)
        ttk.Label(row, text=gui._x11(label), width=12).pack(side='left')
        self.var = tk.StringVar()
        self.entry = ttk.Entry(row, textvariable=self.var, width=12)
        self.entry.pack(side='left')
        self.entry.bind('<Return>', self.text_input)
        gui.ui_callbacks[key].add(self.update_text)
        self.update_text()

    def format_value(self, value: float) -> str:
        return f'{value:.8g}'

    def update_text(self) -> None:
        try:
            self.var.set(self.format_value(self.get_value()))
        except Exception:
            self.var.set('')

    def text_input(self, *_: Any) -> None:
        try:
            value = float(self.var.get())
        except ValueError:
            self.update_text()
            return
        try:
            self.gui.set_value(self.key, value)
        except Exception as exc:
            traceback.print_exc()
            messagebox.showwarning('Invalid value', str(exc))
            self.update_text()
