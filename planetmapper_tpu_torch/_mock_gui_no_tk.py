"""
Graceful degradation when tkinter is unavailable: importing the package
still works, and only *using* the GUI raises an informative error
(behavioural parity with the reference's mock-module fallback).
"""

from __future__ import annotations

from typing import Callable, NoReturn

ERROR_MESSAGE = (
    'The "tkinter" package is not included in your Python installation, so '
    'planetmapper_tpu_torch cannot create a graphical user interface. '
    'See https://docs.python.org/3/library/tkinter.html for more information.'
)


def raise_tkinter_import_error(parent_exception: ImportError) -> NoReturn:
    """
    Re-raise an import failure as an informative tkinter error (or
    unchanged, if tkinter was not actually the missing module).
    """
    name = getattr(parent_exception, 'name', None)
    if name and 'tkinter' in name:
        raise ModuleNotFoundError(
            ERROR_MESSAGE, name='tkinter'
        ) from parent_exception
    raise parent_exception


def get_mocks(
    parent_exception: ImportError,
) -> tuple[object, Callable[..., NoReturn]]:
    """
    Build the ``(gui_module_stand_in, run_gui_stand_in)`` pair used by the
    package ``__init__`` when the real GUI module cannot be imported. Any
    attribute access or call on either raises the informative error.
    """

    def fail(*_args, **_kwargs) -> NoReturn:
        raise_tkinter_import_error(parent_exception)

    mock_module = type(
        '_MockGUIModule',
        (),
        {
            '__getattr__': lambda self, name: fail(),
            '__doc__': 'GUI unavailable: tkinter is not installed.',
        },
    )()
    return mock_module, fail
