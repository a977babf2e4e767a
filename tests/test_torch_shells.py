"""
The port's shells against the JAX package's, on the CPU:

- the CLI (``--version``, ``--precision``, ``--prewarm``'s dispatch and
  its plain run at 16 px on the CPU; without a card it raises),
  ``python -m planetmapper_tpu_torch`` and the console script's entry;
- the GUI with no window (tk mocked where widgets are built, as the JAX
  package's ``tests/test_shells.py`` does): its shortcut tables, its
  disc-finding registry, click coordinates and their strings, image modes
  and limits, step logic, the WCS-offset round trip and the plot settings
  held against a JAX ``GUI`` over the JAX Observation of the same file;
  every disc-finding routine through the GUI against the direct call; the
  save popup's worker (files HDU by HDU against direct saves, a cancel
  leaves no file); ``build_gui``/``run`` with tk mocked; tkinter missing;
- ``_mock_gui_no_tk``, ``kernel_downloader`` (urllib mocked; the URL and
  path conversions against the JAX module's), the session warm thread;
- the native DAF reader: built with the C++ compiler here, and read word
  for word and summary for summary as the pure-Python reader reads.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import tomllib
import unittest.mock as mock

import jax  # noqa: F401  (the JAX package under test runs on it)
import matplotlib

matplotlib.use('Agg')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import planetmapper_tpu as jpm  # noqa: E402
import planetmapper_tpu_torch as tpm  # noqa: E402
from planetmapper_tpu import kernel_downloader as j_kd  # noqa: E402
from planetmapper_tpu.kernels import pool as j_pool  # noqa: E402
from planetmapper_tpu_torch import (  # noqa: E402
    _mock_gui_no_tk,
    _session_warm,
    cli,
    kernel_downloader,
)
from planetmapper_tpu_torch.io import fits as t_fits  # noqa: E402
from planetmapper_tpu_torch.kernels import daf as t_daf  # noqa: E402
from planetmapper_tpu_torch.kernels import daf_native  # noqa: E402
from planetmapper_tpu_torch.kernels import pool as t_pool  # noqa: E402
from planetmapper_tpu_torch.testing import compare  # noqa: E402
from planetmapper_tpu_torch.testing.observation_files import (  # noqa: E402
    disc_cube,
    write_observation,
)
from planetmapper_tpu_torch.testing.synthetic_kernels import (  # noqa: E402
    write_synthetic_kernels,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTC = '2005-01-01T00:00:00'
NZ, NY, NX = 3, 48, 64
DISC = (30.3, 22.8, 15.2, 20.0)
#: The GUI's disc after the user's nudges: the start of the disc fits
START = (33.1, 20.4, 13.9, 31.0)
#: Port against the JAX package (float64 both): testing/compare.py
DEG = compare.F64_ANGLE
DISC_PX = 1e-9
#: limb distance and ring radius [km]: a fraction of the target distance
KM_RELATIVE = compare.F64_POSITION_RELATIVE


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def kernels(tmp_path_factory):
    """Both packages on the synthetic kernels; restored afterwards."""
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0)
    previous = {
        pkg: pkg.get_kernel_path(return_source=True) for pkg in (jpm, tpm)
    }
    for pkg, pool_mod in ((jpm, j_pool), (tpm, t_pool)):
        pkg.clear_kernels()
        pkg.set_kernel_path(path)
        pool_mod.load_spice_kernels()
    yield path
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


@pytest.fixture(scope='module')
def obs_path(kernels, tmp_path_factory):
    """A 3-frame 64x48 cube (a bright disc on noise, a NaN block) with a
    TAN WCS that puts the target on DISC, written by the port."""
    rng = np.random.default_rng(3)
    cube = disc_cube(rng.normal(size=(NZ, NY, NX)), DISC)
    cube *= np.arange(1, NZ + 1)[:, None, None]
    cube[1, 20:23, 40:44] = np.nan
    path = str(tmp_path_factory.mktemp('observation') / 'obs.fits')
    write_observation(path, cube, DISC, UTC)
    return path


def _observations(path):
    """(JAX Observation, port CPU Observation) of ``path`` at START."""
    j_obs = jpm.Observation(path)
    t_obs = tpm.Observation(path, device='cpu')
    for obs in (j_obs, t_obs):
        obs.set_disc_params(*START)
    return j_obs, t_obs


@pytest.fixture()
def guis(obs_path):
    """(JAX GUI, port GUI), each over its package's Observation of the
    same file."""
    from planetmapper_tpu import gui as j_gui

    j_obs, t_obs = _observations(obs_path)
    j_g = j_gui.GUI()
    t_g = tpm.gui.GUI()
    j_g.observation, t_g.observation = j_obs, t_obs
    return j_g, t_g


# ---------------------------------------------------------------------------
# GUI logic against the JAX GUI
# ---------------------------------------------------------------------------

def test_shortcut_tables_match_jax(guis):
    j_g, t_g = guis
    assert {fn.__name__: keys for fn, keys in t_g.shortcuts.items()} == \
        {fn.__name__: keys for fn, keys in j_g.shortcuts.items()}
    assert t_g.shortcuts_to_keep_in_entry == j_g.shortcuts_to_keep_in_entry
    keys = [k for keys in t_g.shortcuts.values() for k in keys]
    assert len(set(keys)) == len(keys)


def test_disc_finding_registry_matches_jax(guis):
    """Sections, labels, tooltips and requirements; the gradient fit's
    tooltip names the observation's device instead of the TPU."""
    j_g, t_g = guis
    assert list(t_g.disc_finding_routines) == list(j_g.disc_finding_routines)
    for section, rows in t_g.disc_finding_routines.items():
        ref = j_g.disc_finding_routines[section]
        assert [r[1] for r in rows] == [r[1] for r in ref]
        assert [r[3] for r in rows] == [r[3] for r in ref]
        for (_, label, tip, _), (_, _, j_tip, _) in zip(rows, ref):
            if label == 'Fit disc (gradient descent)':
                assert 'TPU' not in tip and 'card' in tip
            else:
                assert tip == j_tip
        assert all(callable(r[0]) for r in rows)


#: Pixels: on the disc, near its limb, and off it
CLICKS = [(31.0, 23.5), (27.2, 33.9), (3.0, 40.0)]


@pytest.mark.parametrize('xy', CLICKS)
def test_click_coords_match_jax(guis, xy):
    j_g, t_g = guis
    got = t_g._get_coords_for_location(*xy)
    ref = j_g._get_coords_for_location(*xy)
    assert set(got) == set(ref)
    assert (got['x'], got['y']) == xy
    distance = t_g.get_observation().target_distance
    for key, value in ref.items():
        bar = KM_RELATIVE * distance if key in ('limb_distance',
                                                'ring_radius') else DEG
        assert abs(got[key] - value) <= bar, (key, got[key], value)
    for g in (t_g, j_g):
        g.last_click_location = xy
    assert t_g.get_click_coords().keys() == got.keys()
    assert t_g.make_click_json_string(got) == j_g.make_click_json_string(ref)
    assert t_g.make_click_json_string(got, fmt='', fmt_radec='') \
        .startswith('{"xy": [')
    strs = t_g.get_click_coords_formatted_strings(got)
    assert strs == j_g.get_click_coords_formatted_strings(ref)
    assert t_g.make_click_formatted_string(strs) == \
        j_g.make_click_formatted_string(strs)
    if 'lon' in ref:
        assert np.allclose(t_g.get_observation().xy2lonlat(*xy),
                           (got['lon'], got['lat']), rtol=0, atol=1e-12)


def test_update_coords_fills_the_copy_strings(guis):
    _, t_g = guis
    t_g.last_click_location = CLICKS[0]
    t_g.update_coords()
    assert t_g.coords_machine_str.startswith('{"xy": [')
    assert 'Pixel coordinates' in t_g.coords_formatted_str


@pytest.mark.parametrize('mode', ['single', 'sum', 'rgb'])
@pytest.mark.parametrize('gamma', [1, 2.2])
def test_image_modes_match_jax(guis, mode, gamma):
    j_g, t_g = guis
    for g in guis:
        g.plot_settings['_'].update(image_mode=mode, image_gamma=gamma,
                                    image_idx_single=2, image_idx_r=2,
                                    image_idx_g=0, image_idx_b=1)
    got, ref = t_g.get_image(), j_g.get_image()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('limit_type, vmin, vmax', [
    ('relative', 0, 100), ('relative', 5, 95), ('absolute', 2.0, 5.0),
    ('percentile', 1, 99), ('percentile', 0, 50),
])
def test_image_limits_match_jax(guis, limit_type, vmin, vmax):
    j_g, t_g = guis
    for g in guis:
        g.plot_settings['_'].update(image_limit_type=limit_type,
                                    image_vmin=vmin, image_vmax=vmax)
    img = t_g.image_sum()
    assert t_g.get_image_limits(img) == j_g.get_image_limits(img)
    empty = np.full((3, 3), np.nan)
    assert t_g.get_image_limits(empty) == j_g.get_image_limits(empty)


def test_step_logic_and_nudges_match_jax(guis):
    j_g, t_g = guis
    for g in guis:
        g.set_step(2.0)
        g.increase_step()
        g.decrease_step()
        g.decrease_step()
        assert g.step_size == pytest.approx(0.2)
        with pytest.raises(ValueError):
            g.set_step(-1.0)
        with pytest.raises(ValueError):
            g.set_step(float('nan'))
        for nudge in ('move_up', 'move_right', 'move_down_left',
                      'rotate_left', 'increase_radius', 'decrease_radius',
                      'increase_radius'):
            getattr(g, nudge)()
        g.set_value('x0', 35.25)
    np.testing.assert_allclose(t_g.get_observation().get_disc_params(),
                               j_g.get_observation().get_disc_params(),
                               rtol=0, atol=1e-12)
    assert t_g.get_observation().get_x0() == 35.25


def test_wcs_offsets_round_trip_matches_jax(guis):
    j_g, t_g = guis
    for g in guis:
        g.get_observation().disc_from_wcs(
            suppress_warnings=True, validate=False, use_header_offsets=False)
    got, ref = t_g._get_wcs_offsets(), j_g._get_wcs_offsets()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:2], (0.0, 0.0), rtol=0, atol=1e-8)
    for offsets in (dict(dra_arcsec=1.0, ddec_arcsec=-0.5),
                    dict(dr0=0.7, drotation=3.0)):
        for g in guis:
            g._set_wcs_offsets(**offsets)
        np.testing.assert_allclose(t_g.get_observation().get_disc_params(),
                                   j_g.get_observation().get_disc_params(),
                                   rtol=0, atol=DISC_PX)
        np.testing.assert_allclose(t_g._get_wcs_offsets(),
                                   j_g._get_wcs_offsets(), rtol=0, atol=1e-6)
        dra, ddec, dr0, drot = t_g._get_wcs_offsets()
        if 'dr0' in offsets:
            assert (dr0, drot) == pytest.approx((0.7, 3.0), abs=1e-9)
        else:
            # set/get linearise the radec<->xy mapping at slightly different
            # points: the round trip holds at the 1e-3 arcsec level
            assert (dra, ddec) == pytest.approx((1.0, -0.5), abs=1e-3)


def test_plot_settings_defaults_match_jax(guis):
    from planetmapper_tpu import _gui_settings as j_settings
    from planetmapper_tpu import gui as j_gui
    from planetmapper_tpu_torch import _gui_settings as t_settings

    _, t_g = guis
    t_gui = tpm.gui
    assert t_gui.DEFAULT_PLOT_SETTINGS == j_gui.DEFAULT_PLOT_SETTINGS
    for name in ('LINESTYLES', 'MARKERS', 'GRID_INTERVALS', 'CMAPS',
                 'LIMIT_TYPES', 'MAP_INTERPOLATIONS', 'MAP_PROJECTIONS'):
        assert getattr(t_gui, name) == getattr(j_gui, name), name
    assert t_g.plot_settings == t_gui.DEFAULT_PLOT_SETTINGS
    t_g.plot_settings['limb']['color'] = 'r'
    assert t_gui.DEFAULT_PLOT_SETTINGS['limb']['color'] == 'w'
    t_settings._build_specs()
    j_settings._build_specs()
    assert t_settings.ARTIST_FIELD_SPECS == j_settings.ARTIST_FIELD_SPECS
    assert t_settings.ARTIST_LABELS == j_settings.ARTIST_LABELS
    assert t_settings.REPLOT_ACTIONS == j_settings.REPLOT_ACTIONS
    assert t_g.coords_labels == guis[0].coords_labels


# ---------------------------------------------------------------------------
# The disc-finding routines, the device, the save popup's worker
# ---------------------------------------------------------------------------

def _routines(g):
    return {label: fn for rows in g.disc_finding_routines.values()
            for fn, label, _, _ in rows}


#: Each registry row's direct call on an Observation
DIRECT = {
    'Reset all disc parameters': lambda o: o.reset_disc_params(),
    'Centre disc in image': lambda o: o.centre_disc(),
    'Rotate north to top': lambda o: o.rotate_north_to_top(),
    'Use PlanetMapper metadata': lambda o: o.disc_from_header(),
    'Use WCS position, rotation & scale': lambda o: o.disc_from_wcs(
        suppress_warnings=True, validate=False, use_header_offsets=False),
    'Use WCS position': lambda o: o.position_from_wcs(
        suppress_warnings=True, validate=False, use_header_offsets=False),
    'Use WCS rotation': lambda o: o.rotation_from_wcs(
        suppress_warnings=True, validate=False, use_header_offsets=False),
    'Use WCS plate scale': lambda o: o.plate_scale_from_wcs(
        suppress_warnings=True, validate=False, use_header_offsets=False),
    'Fit disc position': lambda o: o.fit_disc_position(),
    'Fit disc radius': lambda o: o.fit_disc_radius(),
    'Fit disc (gradient descent)': lambda o: tpm.parallel.fit_disc_gradient(
        o),
}


def _navigated(path):
    """A port CPU Observation at START whose header carries PLANMAP
    metadata for DISC (the 'header' routine's input)."""
    obs = tpm.Observation(path, device='cpu')
    obs.set_disc_params(*DISC)
    obs.add_header_metadata()
    obs.set_disc_params(*START)
    return obs


@pytest.mark.parametrize('label', sorted(DIRECT))
def test_disc_finding_routine_equals_direct_call(obs_path, label):
    """The registry row, run as its button runs it, sets the disc the
    direct call sets on a fresh Observation of the same file."""
    g = tpm.gui.GUI(allow_open=False)
    g.set_observation(_navigated(obs_path))
    assert set(_routines(g)) == set(DIRECT)
    g.make_disc_finding_fn(_routines(g)[label])()
    direct = _navigated(obs_path)
    DIRECT[label](direct)
    assert g.get_observation().get_disc_params() == \
        direct.get_disc_params()
    assert g.get_observation().get_disc_method() == \
        direct.get_disc_method()
    assert g.disc_method_message == \
        f'Disc method: {direct.get_disc_method()}'


def test_gui_device_reaches_the_open_dialog(obs_path):
    """GUI(device=...) is the device of what the open dialog opens (the
    card when not given); an explicit device wins."""
    from planetmapper_tpu_torch import _gui_popups

    assert tpm.gui.GUI().device is None
    for gui_device, popup_device, want in ((None, None, None),
                                           ('cpu', None, 'cpu'),
                                           ('cpu', 'meta', 'meta')):
        g = tpm.gui.GUI(device=gui_device)
        with mock.patch.object(_gui_popups.Popup, '__init__',
                               return_value=None):
            popup = _gui_popups.OpenObservation(g, device=popup_device)
        assert popup.device == want
        popup.gui = g
        popup.path_var = mock.MagicMock(get=lambda: obs_path)
        popup.field_vars = {'target': mock.MagicMock(get=lambda: '')}
        popup.window = None
        with mock.patch.object(_gui_popups, 'Observation') as opened:
            opened.return_value.data = np.zeros((1, 2, 2))
            assert popup.apply_changes()
        opened.assert_called_once_with(obs_path, device=want)
        assert g.observation is opened.return_value


def test_run_gui_from_cli_opens_on_the_device(obs_path):
    with mock.patch.object(tpm.gui, 'GUI') as gui_class, \
            mock.patch.object(tpm.gui, 'Observation') as obs_class, \
            mock.patch.object(
                tpm.gui, '_maybe_switch_matplotlib_backend_to_tkagg'):
        tpm.run_gui(obs_path, device='cpu')
    gui_class.assert_called_once_with(device='cpu')
    obs_class.assert_called_once_with(obs_path, device='cpu')
    gui_class.return_value.set_observation.assert_called_once_with(
        obs_class.return_value)
    gui_class.return_value.run.assert_called_once_with()


def _saving_popup(g, nav_path, map_path, map_kwargs):
    """A SavingProgress with its window mocked away (its worker runs
    synchronously in the test)."""
    from planetmapper_tpu_torch import _gui_popups

    with mock.patch.object(_gui_popups.Popup, '__init__', return_value=None):
        popup = _gui_popups.SavingProgress(
            g, nav_path=nav_path, map_path=map_path, map_kwargs=map_kwargs)
    popup.gui = g
    return popup


MAP_KW = dict(degree_interval=15, interpolation='linear')


def _hdus(path):
    with t_fits.open(path) as hdul:
        return [(h.name, h.header, None if h.data is None else
                 np.array(h.data)) for h in hdul]


def test_saving_progress_writes_the_direct_saves(obs_path, tmp_path):
    """The popup's worker writes, HDU by HDU, what save_observation and
    save_mapped_observation write when called directly (WIREFRAME HDU
    included), and reports progress."""
    g = tpm.gui.GUI(allow_open=False)
    g.set_observation(_navigated(obs_path))
    paths = {k: str(tmp_path / f'{k}.fits') for k in
             ('nav', 'map', 'nav_direct', 'map_direct')}
    popup = _saving_popup(g, paths['nav'], paths['map'], MAP_KW)
    popup.run_save()
    assert popup.finished and popup.error is None
    assert popup.progress_value > 0.5
    assert g.get_observation()._get_progress_hook() is None
    direct = _navigated(obs_path)
    direct.save_observation(paths['nav_direct'], print_info=False)
    direct.save_mapped_observation(paths['map_direct'], print_info=False,
                                   **MAP_KW)
    for kind in ('nav', 'map'):
        got, ref = _hdus(paths[kind]), _hdus(paths[f'{kind}_direct'])
        assert [h[0] for h in got] == [h[0] for h in ref]
        assert got[-1][0] == 'WIREFRAME'
        for (name, header, data), (_, r_header, r_data) in zip(got, ref):
            assert not compare.compare_headers(
                header, r_header, angle=0.0, pixel=0.0, relative=0.0), name
            if r_data is None:
                assert data is None
            else:
                np.testing.assert_array_equal(data, r_data, err_msg=name)


@pytest.mark.parametrize('after_calls', [0, 5])
def test_cancelled_save_leaves_no_file(obs_path, tmp_path, after_calls):
    """CancelSave raised from the progress hook (at once, or mid-save)
    stops the worker, synchronises the observation's device and removes
    the files."""
    from planetmapper_tpu_torch import _gui_popups

    g = tpm.gui.GUI(allow_open=False)
    g.set_observation(_navigated(obs_path))
    paths = [str(tmp_path / 'nav.fits'), str(tmp_path / 'map.fits')]
    popup = _saving_popup(g, *paths, MAP_KW)
    hook = popup._progress_hook
    calls = []

    def counting_hook(progress, stack):
        calls.append(progress)
        if len(calls) > after_calls:
            popup.click_cancel()
        hook(progress, stack)

    popup._progress_hook = counting_hook
    with mock.patch.object(_gui_popups, '_synchronise',
                           wraps=_gui_popups._synchronise) as sync:
        popup.run_save()
    assert popup.finished and popup.error is None and popup.cancelled
    sync.assert_called_once_with(g.get_observation())
    assert not any(os.path.exists(p) for p in paths)
    assert not os.listdir(tmp_path)
    assert g.get_observation()._get_progress_hook() is None


# ---------------------------------------------------------------------------
# Widget construction with tk mocked; tkinter missing
# ---------------------------------------------------------------------------

def _mocked_tk():
    gui_module = tpm.gui
    return [
        mock.patch.object(gui_module, 'tk', mock.MagicMock()),
        mock.patch.object(gui_module, 'ttk', mock.MagicMock()),
        mock.patch.object(gui_module, 'FigureCanvasTkAgg', mock.MagicMock()),
        mock.patch.object(gui_module, 'NavigationToolbar2Tk',
                          mock.MagicMock()),
        mock.patch.object(gui_module, 'Figure', mock.MagicMock()),
        mock.patch('planetmapper_tpu_torch._gui_settings.tk',
                   mock.MagicMock()),
        mock.patch('planetmapper_tpu_torch._gui_settings.ttk',
                   mock.MagicMock()),
    ]


def test_build_gui_with_mocked_tk(obs_path):
    g = tpm.gui.GUI()
    g.observation = _navigated(obs_path)
    patches = _mocked_tk()
    for p in patches:
        p.start()
    try:
        g.root = mock.MagicMock()
        g.build_gui()
    finally:
        for p in reversed(patches):
            p.stop()
    assert g.notebook is not None
    assert g.root.bind.called
    assert set(g.numeric_entries) == {'x0', 'y0', 'r0', 'rotation', 'step'}
    assert g._wcs_offset_vars
    assert set(g.coords_tab_labels) == {
        key for rows in g.coords_labels.values() for key, _, _ in rows}
    bound = {c.args[0] for c in g.root.bind.call_args_list}
    assert bound == {k for keys in g.shortcuts.values() for k in keys}


def test_run_with_mocked_tk(obs_path):
    g = tpm.gui.GUI(allow_open=False)
    g.observation = _navigated(obs_path)
    patches = _mocked_tk() + [
        mock.patch.object(tpm.gui.GUI, 'after_setting_observation'),
        mock.patch.object(tpm.gui, '_maybe_switch_matplotlib_backend_to_tkagg'),
    ]
    mocks = [p.start() for p in patches]
    try:
        g.run()
        mocks[-2].assert_called_once_with()
        mocks[-1].assert_called_once_with()
    finally:
        for p in reversed(patches):
            p.stop()
    with pytest.raises(ValueError, match='No observation'):
        tpm.gui.GUI(allow_open=False).run()


def test_gui_without_tkinter_raises_the_informative_error(obs_path):
    """With tkinter unimportable the GUI module still imports, a GUI over
    an observation still runs its routines, and opening a window (through
    ``tpm.run_gui`` or ``GUI.run``) raises the informative error."""
    with mock.patch.dict(sys.modules, {'tkinter': None}):
        g = tpm.gui.GUI(allow_open=False)
        g.set_observation(_navigated(obs_path))
        g.make_disc_finding_fn(_routines(g)['Centre disc in image'])()
        with pytest.raises(ModuleNotFoundError) as excinfo:
            tpm.run_gui()
        assert excinfo.value.name == 'tkinter'
        assert str(excinfo.value) == _mock_gui_no_tk.ERROR_MESSAGE
        with pytest.raises(ModuleNotFoundError, match='tkinter'):
            g.run()


def test_package_gui_falls_back_to_the_mocks():
    """When the GUI module itself fails to import for want of tkinter, the
    package's ``gui``/``run_gui`` are the mocks (the JAX package's
    fallback)."""
    error = ModuleNotFoundError('No module named tkinter', name='tkinter')
    import importlib

    real = importlib.import_module

    def fake(name, package=None):
        if name == '.gui' and package == 'planetmapper_tpu_torch':
            raise error
        return real(name, package)

    # the package's module __getattr__, as on first access to tpm.gui
    with mock.patch('importlib.import_module', side_effect=fake):
        gui_mock = tpm.__getattr__('gui')
        run_gui_mock = tpm.__getattr__('run_gui')
    with pytest.raises(ModuleNotFoundError, match='tkinter'):
        gui_mock.GUI
    with pytest.raises(ModuleNotFoundError, match='tkinter'):
        run_gui_mock()


def test_raise_for_missing_tkinter():
    exc = ModuleNotFoundError('No module named tkinter', name='tkinter')
    with pytest.raises(ModuleNotFoundError) as excinfo:
        _mock_gui_no_tk.raise_tkinter_import_error(exc)
    assert 'tkinter' in str(excinfo.value)
    assert excinfo.value.name == 'tkinter'


def test_reraise_other_import_errors():
    exc = ImportError('something else', name='numpy')
    with pytest.raises(ImportError) as excinfo:
        _mock_gui_no_tk.raise_tkinter_import_error(exc)
    assert excinfo.value is exc


def test_mocks():
    exc = ModuleNotFoundError('No module named tkinter', name='tkinter')
    gui_mock, run_gui_mock = _mock_gui_no_tk.get_mocks(exc)
    with pytest.raises(ModuleNotFoundError):
        gui_mock.GUI
    with pytest.raises(ModuleNotFoundError):
        run_gui_mock()


def test_assets_are_the_ports_own():
    from planetmapper_tpu import _assets as j_assets
    from planetmapper_tpu_torch import _assets as t_assets

    path = t_assets.get_gui_icon_path()
    assert os.path.dirname(os.path.dirname(path)) == \
        os.path.dirname(tpm.__file__)
    with open(path, 'rb') as a, open(j_assets.get_gui_icon_path(), 'rb') as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_version(capsys):
    with pytest.raises(SystemExit) as excinfo:
        cli.main(['--version'])
    assert excinfo.value.code == 0
    out = capsys.readouterr().out
    assert out.strip() == f'planetmapper_tpu_torch {tpm.__version__}'


def test_launches_gui():
    with mock.patch('planetmapper_tpu_torch.gui._run_gui_from_cli') as run:
        cli.main([])
    run.assert_called_once_with(None)
    with mock.patch('planetmapper_tpu_torch.gui._run_gui_from_cli') as run:
        cli.main(['some_file.fits'])
    run.assert_called_once_with('some_file.fits')


def test_precision_flag():
    before = tpm.pipeline.DEFAULT_PRECISION
    try:
        with mock.patch('planetmapper_tpu_torch.gui._run_gui_from_cli'):
            cli.main(['--precision', 'double'])
        assert tpm.pipeline.DEFAULT_PRECISION == 'double'
    finally:
        tpm.pipeline.DEFAULT_PRECISION = before


def test_bad_precision():
    with pytest.raises(SystemExit):
        cli.main(['--precision', 'bogus'])


@pytest.mark.parametrize('argv, call', [
    (['--prewarm', '64', '128', '--target', 'Saturn'],
     ('Saturn', 'EARTH', [64, 128])),
    (['--prewarm'], ('JUPITER', 'EARTH', [512, 1024, 2048])),
    (['--prewarm', '32', '--observer', 'HST'], ('JUPITER', 'HST', [32])),
])
def test_prewarm_dispatch_matches_jax(argv, call):
    """--prewarm parses as the JAX CLI's and never launches the GUI."""
    from planetmapper_tpu import cli as j_cli

    for module, gui_name in ((cli, 'planetmapper_tpu_torch.gui'),
                             (j_cli, 'planetmapper_tpu.gui')):
        with mock.patch.object(module, '_prewarm') as prewarm, \
                mock.patch(f'{gui_name}._run_gui_from_cli') as run:
            module.main(argv)
        prewarm.assert_called_once_with(*call)
        run.assert_not_called()


def test_prewarm_runs_on_the_cpu_when_asked(kernels, capsys):
    """The private device= runs the plain versions at 16 px: the three
    lines, no library build."""
    with mock.patch('planetmapper_tpu_torch.ops.cuda_build.build_all') as b:
        cli._prewarm('JUPITER', 'EARTH', [16], device='cpu')
    b.assert_not_called()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith('prewarm JUPITER/EARTH 16x16: backplane '
                               'kernel ran in ')
    assert lines[1].startswith('prewarm 16x16: map reprojection ran in ')
    assert lines[2] == 'kernel build directory: ' + os.path.join(REPO,
                                                                 'build')


def test_prewarm_raises_without_a_card(kernels, capsys):
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['--prewarm', '16'])
    assert 'prewarm' not in capsys.readouterr().out


def test_module_entry_prints_the_version():
    proc = subprocess.run(
        [sys.executable, '-m', 'planetmapper_tpu_torch', '--version'],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f'planetmapper_tpu_torch {tpm.__version__}'


def test_console_script_and_package_data():
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as f:
        project = tomllib.load(f)
    target = project['project']['scripts']['planetmapper-tpu-torch']
    module, func = target.split(':')
    assert (module, func) == ('planetmapper_tpu_torch.cli', 'main')
    data = project['tool']['setuptools']['package-data'][
        'planetmapper_tpu_torch']
    assert {'assets/*', 'native/*'} <= set(data)


# ---------------------------------------------------------------------------
# The session warm thread
# ---------------------------------------------------------------------------

@pytest.fixture()
def fresh_warm(monkeypatch):
    """The session-warm module as a new process sees it."""
    monkeypatch.setattr(_session_warm, '_started', False)
    monkeypatch.setattr(_session_warm, '_thread', None)
    monkeypatch.delenv('PLANETMAPPER_TPU_SESSION_WARM', raising=False)
    return _session_warm


def test_session_warm_needs_a_card(fresh_warm, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    fresh_warm.start_session_warm('cuda')
    assert fresh_warm._thread is None
    fresh_warm.wait_for_session(0.1)


@pytest.mark.parametrize('device', [None, 'cpu', torch.device('cpu'),
                                    'meta'])
def test_session_warm_skips_bodies_off_the_card(fresh_warm, monkeypatch,
                                                device):
    """A body off the card starts nothing even on a card host, and a later
    card body still can."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    warm = mock.MagicMock()
    monkeypatch.setattr(fresh_warm, '_session_warm', warm)
    fresh_warm.start_session_warm(device)
    assert fresh_warm._thread is None and not fresh_warm._started
    fresh_warm.start_session_warm('cuda:0')
    fresh_warm.wait_for_session(10)
    warm.assert_called_once_with(torch.device('cuda:0'))


def test_session_warm_disabled_by_env(fresh_warm, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setenv('PLANETMAPPER_TPU_SESSION_WARM', '0')
    warm = mock.MagicMock()
    monkeypatch.setattr(fresh_warm, '_session_warm', warm)
    fresh_warm.start_session_warm('cuda')
    assert fresh_warm._thread is None
    warm.assert_not_called()


def test_session_warm_starts_once_and_joins(fresh_warm, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    release = threading.Event()
    calls = []

    def stub(device):
        calls.append((threading.current_thread().name, device))
        release.wait(10)

    monkeypatch.setattr(fresh_warm, '_session_warm', stub)
    fresh_warm.start_session_warm('cuda')
    thread = fresh_warm._thread
    assert thread is not None and thread.daemon
    fresh_warm.start_session_warm('cuda')
    assert fresh_warm._thread is thread
    fresh_warm.wait_for_session(0.05)
    assert thread.is_alive()
    release.set()
    fresh_warm.wait_for_session(10)
    assert not thread.is_alive()
    assert calls == [('planetmapper-session-warm', torch.device('cuda'))]


def test_spicebase_starts_the_session_warm(kernels, monkeypatch):
    """SpiceBase passes the body's device: a BodyXY's own, a Body's the
    host's."""
    start = mock.MagicMock()
    monkeypatch.setattr(_session_warm, 'start_session_warm', start)
    tpm.Body('Jupiter', utc=UTC)
    start.assert_called_once_with(torch.device('cpu'))
    start.reset_mock()
    tpm.BodyXY('Jupiter', utc=UTC, sz=8, device='cpu')
    start.assert_called_once_with(torch.device('cpu'))
    start.reset_mock()
    tpm.SpiceBase()
    start.assert_called_once_with(None)


# ---------------------------------------------------------------------------
# The kernel downloader (offline: urllib mocked)
# ---------------------------------------------------------------------------

def test_url_root():
    assert kernel_downloader.URL_ROOT == j_kd.URL_ROOT == \
        'https://naif.jpl.nasa.gov/pub/'


@pytest.mark.parametrize('url_or_path', [
    'https://naif.jpl.nasa.gov/pub/naif/generic_kernels/pck/x.tpc',
    'https://naif.jpl.nasa.gov/pub/naif/generic_kernels/spk/',
    'https://naif.jpl.nasa.gov/pub/naif/HST/kernels/spk/hst.bsp',
])
def test_url_path_conversions_match_jax(kernels, url_or_path):
    for name in ('_get_kernel_path', '_convert_url_to_local_path',
                 '_check_kernel_exists_locally'):
        assert getattr(kernel_downloader, name)(url_or_path) == \
            getattr(j_kd, name)(url_or_path), name
    kp = kernel_downloader._get_kernel_path(url_or_path)
    assert kernel_downloader._kernel_path_to_url(kp) == \
        j_kd._kernel_path_to_url(kp)
    assert kernel_downloader._kernel_path_to_local_path(kp) == \
        j_kd._kernel_path_to_local_path(kp)
    local = kernel_downloader._convert_url_to_local_path(url_or_path)
    assert local.startswith(os.path.normpath(tpm.get_kernel_path()))
    assert kernel_downloader._get_kernel_path(local) == kp
    with pytest.raises(ValueError):
        kernel_downloader._get_kernel_path('/somewhere/else/x.tpc')


def test_download_urls_dispatch():
    file_url = kernel_downloader.URL_ROOT + 'naif/a/b.bsp'
    page_url = kernel_downloader.URL_ROOT + 'naif/a/dir'
    with mock.patch.object(kernel_downloader, 'download_kernel') as f, \
            mock.patch.object(kernel_downloader,
                              'download_kernels_from_webpage') as page:
        kernel_downloader.download_urls(file_url, page_url)
    f.assert_called_once_with(file_url)
    page.assert_called_once_with(page_url)


def test_download_kernel_skips_existing():
    url = kernel_downloader.URL_ROOT + 'naif/a/b.bsp'
    with mock.patch.object(kernel_downloader, '_check_kernel_exists_locally',
                           return_value=True), \
            mock.patch.object(kernel_downloader, 'download_file') as dl:
        kernel_downloader.download_kernel(url)
        dl.assert_not_called()
        kernel_downloader.download_kernel(url, force_download=True)
        dl.assert_called_once()


def test_download_kernel_downloads(kernels):
    url = kernel_downloader.URL_ROOT + 'naif/a/b.bsp'
    with mock.patch.object(kernel_downloader, '_check_kernel_exists_locally',
                           return_value=False), \
            mock.patch.object(kernel_downloader, 'download_file') as dl:
        kernel_downloader.download_kernel(url)
    called_url, local_path = dl.call_args[0]
    assert called_url == url
    assert local_path == j_kd._convert_url_to_local_path(url)


def test_get_kernel_paths_from_webpage():
    page = '\n'.join([
        '<html>junk<!--start data_content-->',
        '<img src="/icons/x.gif"> <a href="de440.bsp">de440</a>',
        '<img src="/icons/x.gif"> <a href="subdir/">sub</a>',
        'not a row',
        '</table>rest',
    ])
    url = kernel_downloader.URL_ROOT + 'naif/generic_kernels/spk'
    opened = mock.MagicMock()
    opened.read.return_value = page.encode()
    with mock.patch('urllib.request.urlopen', return_value=opened) as op:
        paths = kernel_downloader.get_kernel_paths_from_webpage(url)
    op.assert_called_once_with(url)
    assert paths == [url + '/de440.bsp']
    with pytest.raises(AssertionError):
        kernel_downloader.get_kernel_paths_from_webpage('https://x/y')
    opened.read.return_value = b'<html>no listing</html>'
    with mock.patch('urllib.request.urlopen', return_value=opened), \
            pytest.raises(ValueError, match='index page'):
        kernel_downloader.get_kernel_paths_from_webpage(url)


def test_download_kernels_from_webpage(capsys):
    url = kernel_downloader.URL_ROOT + 'naif/generic_kernels/spk'
    found = [url + '/a.bsp', url + '/b.bsp']
    with mock.patch.object(kernel_downloader,
                           'get_kernel_paths_from_webpage',
                           return_value=found), \
            mock.patch.object(kernel_downloader, 'download_kernel') as dl:
        kernel_downloader.download_kernels_from_webpage(url)
    assert [c.args[0] for c in dl.call_args_list] == found
    assert [c.kwargs['note'] for c in dl.call_args_list] == ['[1/2] ',
                                                              '[2/2] ']
    assert '2 to download' in capsys.readouterr().out


def _fake_response(chunks, fail_after=None):
    response = mock.MagicMock()
    response.__enter__.return_value = response
    response.headers = {'Content-Length': str(sum(map(len, chunks)))}
    queue = list(chunks) + [b'']

    def read(n):
        if fail_after is not None and len(queue) <= fail_after:
            raise OSError('connection dropped')
        return queue.pop(0)

    response.read.side_effect = read
    return response


def test_download_file_atomic(tmp_path):
    target = str(tmp_path / 'sub' / 'file.bsp')
    with mock.patch('urllib.request.urlopen',
                    return_value=_fake_response([b'DA', b'TA'])):
        kernel_downloader.download_file('http://x/file.bsp', target)
    with open(target, 'rb') as f:
        assert f.read() == b'DATA'
    assert not os.path.exists(target + '.temp')


def test_download_file_cleans_up_partial(tmp_path):
    target = str(tmp_path / 'sub' / 'file.bsp')
    with mock.patch('urllib.request.urlopen',
                    return_value=_fake_response([b'DA', b'TA'],
                                                fail_after=2)):
        with pytest.raises(OSError):
            kernel_downloader.download_file('http://x/file.bsp', target)
    assert not os.path.exists(target)
    assert not os.path.exists(target + '.temp')


# ---------------------------------------------------------------------------
# The native DAF reader
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def spk_path(tmp_path_factory):
    """The synthetic SPK with every optional segment (the type 10 ones
    included)."""
    path = tmp_path_factory.mktemp('daf')
    return write_synthetic_kernels(path, satellites=True, tle=True)[2]


def test_native_reader_builds_here():
    """The library builds with the C++ compiler into build/ and loads: the
    fallback to the Python parser cannot hide a broken build."""
    path = daf_native.build_library()
    assert path is not None and path.exists()
    assert path.parent == daf_native.BUILD_DIR
    assert path.parent == (daf_native.SOURCE.parents[2] / 'build')
    assert daf_native._get_lib() is not None


def test_native_reader_matches_python_parser(spk_path):
    nat = daf_native.read_daf_native(spk_path)
    py = t_daf.read_daf_python(spk_path)
    assert nat is not None
    assert (nat.idword, nat.nd, nat.ni) == (py.idword, py.nd, py.ni)
    assert nat.summaries == py.summaries
    assert [s.integers[3] for s in nat.summaries].count(10) == 3
    assert nat._data.size == py._data.size
    np.testing.assert_array_equal(nat._data.view(np.uint64),
                                  py._data.astype('<f8').view(np.uint64))
    for summary in py.summaries:
        a0, a1 = summary.integers[4:6]
        np.testing.assert_array_equal(nat.words(a0, a1), py.words(a0, a1))


@pytest.mark.parametrize('env', [None, '0', '1'])
def test_read_daf_takes_the_native_reader_only_when_asked(spk_path,
                                                          monkeypatch, env):
    """The Python parser by default (faster: it views one read in place);
    the native reader with PLANETMAPPER_TPU_NATIVE=1, the same words."""
    if env is None:
        monkeypatch.delenv('PLANETMAPPER_TPU_NATIVE', raising=False)
    else:
        monkeypatch.setenv('PLANETMAPPER_TPU_NATIVE', env)
    with mock.patch.object(daf_native, 'read_daf_native',
                           wraps=daf_native.read_daf_native) as native:
        daf = t_daf.read_daf(spk_path)
    asked = env == '1'
    assert native.call_count == int(asked)
    # numpy's frombuffer (the Python parser's view) is read-only
    assert daf._data.flags.writeable == asked
    np.testing.assert_array_equal(
        daf._data, t_daf.read_daf_python(spk_path)._data)
