"""
Declarative plot-settings editors for the GUI.

The reference implements one ``ArtistSetting`` subclass per plot component
(reference gui.py:4029-5140). Here a single spec table maps each plot
component to its editable fields, and one generic editor popup renders
whatever fields the spec declares - same feature surface, one code path.

Field kinds: ``color`` (colour-picker button), ``float`` (numeric entry),
``choice`` (option menu), ``int`` (integer entry), ``bool`` (checkbox).
"""

from __future__ import annotations

import traceback
from typing import Any

import tkinter as tk
from tkinter import colorchooser, messagebox, ttk

import numpy as np

#: (field key, kind, label, extra) per plot component. ``None`` extra for
#: most kinds; for 'choice' it is the option tuple.
ARTIST_FIELD_SPECS: dict[str, list[tuple[str, str, str, Any]]] = {}


def _line_fields() -> list[tuple[str, str, str, Any]]:
    from .gui import LINESTYLES

    return [
        ('color', 'color', 'Colour', None),
        ('linewidth', 'float', 'Linewidth', None),
        ('linestyle', 'choice', 'Linestyle', LINESTYLES),
        ('alpha', 'float', 'Opacity (0-1)', None),
    ]


def _scatter_fields() -> list[tuple[str, str, str, Any]]:
    from .gui import MARKERS

    return [
        ('color', 'color', 'Colour', None),
        ('marker', 'choice', 'Marker', MARKERS),
        ('s', 'float', 'Size', None),
        ('alpha', 'float', 'Opacity (0-1)', None),
    ]


def _build_specs() -> None:
    from .gui import CMAPS, GRID_INTERVALS, LIMIT_TYPES

    ARTIST_FIELD_SPECS.update(
        {
            'limb': _line_fields(),
            'limb_illuminated': _line_fields(),
            'terminator': _line_fields(),
            'ring': _line_fields(),
            'marked_coord': _line_fields(),
            'grid': _line_fields()
            + [
                ('_.grid_interval', 'choice', 'Grid interval (°)',
                 GRID_INTERVALS),
                ('_.grid_lat_limit', 'float', 'Latitude limit (°)', None),
                ('_.grid_planetocentric', 'bool', 'Planetocentric', None),
            ],
            'pole': [
                ('color', 'color', 'Colour', None),
                ('outline_color', 'color', 'Outline colour', None),
            ],
            'coordinate_of_interest_lonlat': _scatter_fields(),
            'coordinate_of_interest_radec': _scatter_fields(),
            'other_body_of_interest_marker': _scatter_fields(),
            'other_body_of_interest_label': [
                ('color', 'color', 'Colour', None),
            ],
            'image': [
                ('cmap', 'choice', 'Colourmap', CMAPS),
                ('_.image_mode', 'choice', 'Mode (for cubes)',
                 ('single', 'sum', 'rgb')),
                ('_.image_idx_single', 'int', 'Wavelength index', None),
                ('_.image_idx_r', 'int', 'R index', None),
                ('_.image_idx_g', 'int', 'G index', None),
                ('_.image_idx_b', 'int', 'B index', None),
                ('_.image_gamma', 'float', 'Gamma', None),
                ('_.image_vmin', 'float', 'vmin', None),
                ('_.image_vmax', 'float', 'vmax', None),
                ('_.image_limit_type', 'choice', 'Limit type', LIMIT_TYPES),
            ],
        }
    )


ARTIST_LABELS: dict[str, str] = {
    'image': 'Observation image',
    'limb': 'Limb',
    'limb_illuminated': 'Illuminated limb',
    'terminator': 'Terminator',
    'grid': 'Lon/lat gridlines',
    'pole': 'Poles',
    'ring': 'Rings',
    'coordinate_of_interest_lonlat': 'Lon/lat points of interest',
    'coordinate_of_interest_radec': 'RA/Dec points of interest',
    'other_body_of_interest_marker': 'Other body markers',
    'other_body_of_interest_label': 'Other body labels',
    'marked_coord': 'Clicked position marker',
}

#: Which replot routine a component needs after a settings change
REPLOT_ACTIONS: dict[str, str] = {
    'image': 'image',
    'grid': 'wireframe',
}


def build_plot_settings_rows(gui, tab: ttk.Frame) -> None:
    """One row per plot component: enabled checkbox + Edit... button."""
    if not ARTIST_FIELD_SPECS:
        _build_specs()
    canvas_frame = ttk.Frame(tab)
    canvas_frame.pack(fill='both', expand=True)
    gui._plot_setting_vars = {}
    for key, label in ARTIST_LABELS.items():
        row = ttk.Frame(canvas_frame)
        row.pack(fill='x', padx=4, pady=1)
        var = tk.BooleanVar(
            value=gui.plot_settings.get(key, {}).get('enabled', True)
        )
        gui._plot_setting_vars[key] = var
        check = ttk.Checkbutton(
            row, text=label, variable=var,
            command=lambda k=key, v=var: _toggle_component(gui, k, v),
        )
        check.pack(side='left')
        ttk.Button(
            row, text='Edit...', width=7,
            command=lambda k=key: ArtistSettingEditor(gui, k),
        ).pack(side='right')
        gui.add_tooltip(check, f'Show or hide: {label}')


def _toggle_component(gui, key: str, var: tk.BooleanVar) -> None:
    gui.plot_settings.setdefault(key, {})['enabled'] = bool(var.get())
    _apply_replot(gui, key)


def _apply_replot(gui, key: str) -> None:
    action = REPLOT_ACTIONS.get(key, 'wireframe')
    try:
        if action == 'image':
            gui.update_only_image()
        else:
            gui.update_plot_wireframe()
    except Exception:
        traceback.print_exc()


class ArtistSettingEditor:
    """
    Generic modal editor for one plot component, rendering the fields its
    spec declares. OK applies and closes; Apply applies; Cancel closes.
    """

    def __init__(self, gui, key: str) -> None:
        if not ARTIST_FIELD_SPECS:
            _build_specs()
        self.gui = gui
        self.key = key
        self.fields = ARTIST_FIELD_SPECS.get(key, _line_fields())
        self.window = tk.Toplevel(gui.root)
        self.window.title(ARTIST_LABELS.get(key, key))
        self.window.transient(gui.root)
        self.vars: dict[str, tk.Variable] = {}
        self.color_buttons: dict[str, tk.Button] = {}
        body = ttk.Frame(self.window)
        body.pack(fill='both', expand=True, padx=8, pady=8)
        for field, kind, label, extra in self.fields:
            row = ttk.Frame(body)
            row.pack(fill='x', pady=2)
            ttk.Label(row, text=gui._x11(label), width=18).pack(side='left')
            value = self._get_setting(field)
            if kind == 'color':
                button = tk.Button(
                    row, width=8,
                    command=lambda f=field: self._pick_color(f),
                )
                color = value if value else '#ffffff'
                try:
                    button.configure(bg=color)
                except tk.TclError:
                    pass
                button.pack(side='left')
                self.color_buttons[field] = button
                var = tk.StringVar(value=str(value) if value else '')
            elif kind == 'bool':
                var = tk.BooleanVar(value=bool(value))
                ttk.Checkbutton(row, variable=var).pack(side='left')
            elif kind == 'choice':
                options = [str(o) for o in (extra or ())]
                var = tk.StringVar(
                    value=str(value) if value is not None else options[0]
                )
                ttk.OptionMenu(
                    row, var, var.get(), *options
                ).pack(side='left')
            else:  # float / int entry
                var = tk.StringVar(
                    value='' if value is None else str(value)
                )
                ttk.Entry(row, textvariable=var, width=10).pack(side='left')
            self.vars[field] = var

        bar = ttk.Frame(self.window)
        bar.pack(fill='x', padx=8, pady=4)
        ttk.Button(bar, text='OK', command=self.click_ok).pack(side='left')
        ttk.Button(bar, text='Apply', command=self.click_apply).pack(
            side='left'
        )
        ttk.Button(bar, text='Cancel', command=self.click_cancel).pack(
            side='left'
        )

    # -- settings access (field may be 'name' or '_.misc_name') -----------
    def _get_setting(self, field: str):
        if field.startswith('_.'):
            return self.gui.plot_settings['_'].get(field[2:])
        return self.gui.plot_settings.get(self.key, {}).get(field)

    def _set_setting(self, field: str, value) -> None:
        if field.startswith('_.'):
            self.gui.plot_settings['_'][field[2:]] = value
        else:
            self.gui.plot_settings.setdefault(self.key, {})[field] = value

    def _pick_color(self, field: str) -> None:
        current = self.vars[field].get() or None
        try:
            _rgb, name = colorchooser.askcolor(
                color=current, parent=self.window
            )
        except tk.TclError:
            name = None
        if name:
            self.vars[field].set(name)
            try:
                self.color_buttons[field].configure(bg=name)
            except tk.TclError:
                pass

    # -- apply --------------------------------------------------------------
    def apply_settings(self) -> bool:
        nz = None
        if self.gui.observation is not None:
            nz = self.gui.get_observation().data.shape[0]
        for field, kind, label, _extra in self.fields:
            raw = self.vars[field].get()
            if kind == 'color':
                if raw:
                    self._set_setting(field, raw)
                continue
            if kind == 'bool':
                self._set_setting(field, bool(raw))
                continue
            if kind == 'choice':
                value: Any = raw
                # numeric-looking choices (grid intervals) stay numeric
                try:
                    value = float(raw)
                except ValueError:
                    pass
                self._set_setting(field, value)
                continue
            if raw == '':
                continue
            try:
                value = int(raw) if kind == 'int' else float(raw)
            except ValueError:
                messagebox.showwarning(
                    'Invalid value', f'{label}: {raw!r} is not a number',
                    parent=self.window,
                )
                return False
            if kind == 'int' and nz is not None and field.startswith(
                '_.image_idx'
            ):
                value = int(np.clip(value, 0, nz - 1))
            self._set_setting(field, value)
        _apply_replot(self.gui, self.key)
        return True

    def click_ok(self) -> None:
        if self.apply_settings():
            self.window.destroy()

    def click_apply(self) -> None:
        self.apply_settings()

    def click_cancel(self) -> None:
        self.window.destroy()
