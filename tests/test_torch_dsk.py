"""
The port's double-single arithmetic (``ops/ds.py``, ``ops/ds64.py``,
``ops/dsk.py``, ``ops/fastmath.py``), ``pipeline.pick_ds`` and the dsk
kernels' plain route (``ops/dsk_kernel.py``) against the JAX package, on
the CPU:

- every constant, word for word, against the JAX module's and against the
  literals of ``csrc/dsk.cu``;
- every function against the JAX function called eagerly (each operation
  its own XLA computation; inside one compiled graph XLA:CPU's
  excess-precision and contraction passes can null error-free terms,
  ``planetmapper_tpu/ops/ds.py:89-101``), on the same inputs made with
  numpy: hi and lo words equal, word for word, wherever the JAX eager call
  is exact; where the two packages take different float32 seeds (the
  ``rsqrt`` family: the port ``1 / sqrt``, correctly rounded, the JAX
  package ``lax.rsqrt``, which XLA:CPU does not round correctly), both are
  held to float64 numpy at the grade written beside the case;
- the three ``TestDskOnTpu`` cases of ``tests/test_pallas_core.py`` through
  ``dsk_kernel`` on CPU tensors (the plain route), with their seeds, sizes
  and grades, and with the lo words shown to carry the precision; and the
  kernel's changes of algorithm: ``two_prod`` by an FMA, transcribed here
  and shown to give the same words on those inputs, and ``atan2_ds`` in
  native float64 (``dsk_kernel.atan2_ds_native``), held to float64 numpy,
  to the JAX function and to the port's zero and NaN conventions;
- NaN propagation and the edge cases of sqrt, recip, atan2 and atan2_ds;
- ``pick_ds`` and its overrides; the wrapper's checks; the dsk bounds.

The kernels against these plain versions on the card are in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmapper_tpu import pipeline as j_pipeline
from planetmapper_tpu.ops import ds as j_ds
from planetmapper_tpu.ops import ds64 as j_ds64
from planetmapper_tpu.ops import dsk as j_dsk
from planetmapper_tpu.ops import fastmath as j_fm
from planetmapper_tpu_torch import pipeline as t_pipeline
from planetmapper_tpu_torch.ops import ds, ds64, dsk, dsk_kernel, fastmath
from planetmapper_tpu_torch.testing import bounds, dsk_cases

N = 1024

#: The JAX tests' grades (tests/test_ds.py, tests/test_pallas_core.py:538-
#: 616; testing/dsk_cases.GRADES), where the two packages' words may
#: differ: relative for the ds roots, absolute radians for the angles.
DS_ROOT_GRADE = 1e-13
ATAN2_DS_GRADE = 5e-12
ATAN2_F32_GRADE = 5e-7
assert dsk_cases.GRADES == dict(mul=DS_ROOT_GRADE, div=DS_ROOT_GRADE,
                                hypot=DS_ROOT_GRADE, atan2_ds=ATAN2_DS_GRADE,
                                atan2=ATAN2_F32_GRADE)
#: ops/fastmath.py after its float64 Newton step, for rsqrt64 and what is
#: built on it: one step from a seed within a float32 ulp leaves (3/2) x
#: (2^-23)^2 = 2.1e-14 relative (both packages reach 1.76e-14 on these
#: inputs; the module's "~3e-15" counts the squared 2^-24 alone)
FASTMATH_GRADE = 1.5 * 2.0 ** -46
#: ds64.sqrt and ds64.rsqrt against numpy's sqrt and 1/sqrt: 2 ulps. The
#: JAX package's float64 sqrt is numpy's; the port's is torch.sqrt, which on
#: large CPU tensors is 1 ulp off on ~0.5% of values (a vectorised path), and
#: the two packages' rsqrt take different roots (lax.rsqrt, 1 / sqrt)
DS64_ROOT_GRADE = 2 * 2.0 ** -52


def _sample(rng, n=N, lo=1e-6, hi=1e9):
    """Log-uniform magnitudes in [lo, hi], random signs (tests/test_ds.py)."""
    mag = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return rng.choice([-1.0, 1.0], n) * mag


def _leaves(x) -> list[np.ndarray]:
    """The arrays of a (nested) tuple result of either package."""
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


def _assert_words_equal(got, want) -> None:
    """Every word of ``got`` (port) equals ``want`` (JAX); NaN matches NaN
    whatever its payload."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan)
        int_type = np.int32 if g.dtype == np.float32 else np.int64
        np.testing.assert_array_equal(g[~nan].view(int_type),
                                      w[~nan].view(int_type))


def _f64(result) -> np.ndarray:
    """A ds result (hi, lo) or a float array as float64 numpy."""
    leaves = _leaves(result)
    return sum(leaf.astype(np.float64) for leaf in leaves)


# ---------------------------------------------------------------------------
# Constants: the port's own copies, word for word
# ---------------------------------------------------------------------------

def _words(values) -> np.ndarray:
    return np.asarray(values, dtype=np.float32).view(np.int32)


def _jax_magic(fn) -> int:
    return int(re.search(r'int32\((0x[0-9A-Fa-f]+)\)',
                         inspect.getsource(fn))[1], 16)


CONSTANTS = {
    # ops/ds.py takes its two_prod and recip_seed from ops/dsk.py: both of
    # the JAX modules' copies are held to the one constant
    'dsk._SPLIT': (lambda: [dsk._SPLIT], lambda: [j_dsk._SPLIT]),
    'ds._SPLIT': (lambda: [dsk._SPLIT], lambda: [j_ds._SPLIT]),
    'dsk.RECIP_MAGIC': (lambda: dsk.RECIP_MAGIC,
                        lambda: _jax_magic(j_dsk.recip_seed)),
    'ds.RECIP_MAGIC': (lambda: dsk.RECIP_MAGIC,
                       lambda: _jax_magic(j_ds.recip_seed)),
    '_ATAN_C': (lambda: dsk._ATAN_C, lambda: j_dsk._ATAN_C),
    '_ATAN_DS_C': (lambda: dsk._ATAN_DS_C, lambda: j_dsk._ATAN_DS_C),
    '_ATAN_DS_C splits': (
        lambda: dsk._ATAN_DS_PAIRS,
        lambda: [j_dsk.const(c) for c in j_dsk._ATAN_DS_C]),
    '_TAN_PI_8': (lambda: [dsk._TAN_PI_8_F], lambda: [j_dsk._TAN_PI_8]),
    '_PI_4': (lambda: dsk._PI_4, lambda: j_dsk._PI_4),
    '_PI_2': (lambda: dsk._PI_2, lambda: j_dsk._PI_2),
    '_PI': (lambda: dsk._PI, lambda: j_dsk._PI),
    # the literals of dsk.atan2 (planetmapper_tpu/ops/dsk.py:238-239)
    'atan2 pi/2, pi': (lambda: [dsk._PI_2_F, dsk._PI_F],
                       lambda: [np.pi / 2, np.pi]),
}


@pytest.mark.parametrize('name', CONSTANTS)
def test_constants_equal_the_jax_modules(name):
    port, jax_ = CONSTANTS[name]
    if name.endswith('RECIP_MAGIC'):
        assert port() == jax_() == 0x7EF311C3
        return
    np.testing.assert_array_equal(_words(port()), _words(jax_()))
    if name in ('_ATAN_DS_C', '_TAN_PI_8'):  # float64 before the split
        np.testing.assert_array_equal(
            np.asarray(port() if name == '_ATAN_DS_C' else [dsk._TAN_PI_8]),
            np.asarray(jax_()))


def _cu_constants() -> dict[str, list]:
    source = (Path(dsk.__file__).resolve().parent.parent / 'csrc' /
              'dsk.cu').read_text()
    found = {}
    for name, body in re.findall(
            r'(?:constexpr|__constant__) (?:float|int) (k\w+)(?:\[\d+\])? = '
            r'\{?([^;{}]+)\}?;',
            source):
        found[name] = [v.strip() for v in body.split(',') if v.strip()]
    return found


def _cu_floats(values) -> list[float]:
    return [float.fromhex(v.rstrip('f')) for v in values]


CU_CONSTANTS = {
    'kRecipMagic': [dsk.RECIP_MAGIC],
    'kAtanC': list(dsk._ATAN_C),
    'kPi2F': [dsk._PI_2_F],
    'kPiF': [dsk._PI_F],
}


@pytest.mark.parametrize('name', CU_CONSTANTS)
def test_kernel_constants_equal_the_ports(name):
    literals = _cu_constants()[name]
    if name == 'kRecipMagic':
        assert [int(v, 16) for v in literals] == CU_CONSTANTS[name]
        return
    values = _cu_floats(literals)
    # each literal is exactly a float32 value, the port's
    np.testing.assert_array_equal(np.float32(values).astype(np.float64),
                                  values)
    np.testing.assert_array_equal(_words(values),
                                  _words(CU_CONSTANTS[name]))


# ---------------------------------------------------------------------------
# Every function against the JAX function, called eagerly
# ---------------------------------------------------------------------------

def _inputs(rng):
    """numpy inputs of every case: float64 a, b (b = a + noise, so that
    differences cancel), positive p, float32 f, and (3, 3) m."""
    a = _sample(rng, lo=1e-3, hi=1e8)
    b = a * (1.0 + 1e-6 * rng.normal(size=N)) + _sample(rng, lo=1e-3, hi=1e3)
    return dict(a=a, b=b, p=np.abs(_sample(rng, lo=1e-6, hi=1e9)),
                f=_sample(rng, lo=1e-3, hi=1e8).astype(np.float32),
                m=rng.normal(size=(3, 3)))


def _split_for(module, conv, inputs):
    """The inputs as each package's values: ds pairs (or ds64 values) of a,
    b, p; the float32 f; the rows of m as ds constants broadcast."""
    split = getattr(module, 'split_f64', None) or module.from_f64
    out = {k: split(conv(inputs[k])) for k in ('a', 'b', 'p')}
    out['f'] = conv(inputs['f'])
    out['m'] = tuple(tuple(split(conv(np.full(N, inputs['m'][i, j])))
                           for j in range(3)) for i in range(3))
    return out


def _jax(x):
    return jnp.asarray(x)


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


#: Cases common to ds and dsk: name -> (fn(module, values), float64
#: reference(inputs) or None for word-for-word equality)
PAIR_CASES = {
    'two_sum': lambda m, v: m.two_sum(v['a'][0], v['b'][0]),
    'quick_two_sum': lambda m, v: m.quick_two_sum(v['a'][0], v['a'][1]),
    'two_prod': lambda m, v: m.two_prod(v['a'][0], v['f']),
    'neg': lambda m, v: m.neg(v['a']),
    'add': lambda m, v: m.add(v['a'], m.neg(v['b'])),
    'sub': lambda m, v: m.sub(v['a'], v['b']),
    'add_f': lambda m, v: m.add_f(v['a'], v['f']),
    'mul': lambda m, v: m.mul(v['a'], v['b']),
    'mul_f': lambda m, v: m.mul_f(v['a'], v['f']),
    'recip_seed': lambda m, v: m.recip_seed(v['a'][0]),
    'recip': lambda m, v: m.recip(v['a']),
    'div': lambda m, v: m.div(v['a'], v['b']),
    'hi': lambda m, v: m.hi(m.add(v['a'], m.neg(v['b']))),
    'dot3': lambda m, v: m.dot3(v['a'], v['b'], v['p'], v['b'], v['p'],
                                v['a']),
}
DS_CASES = {
    **PAIR_CASES,
    'from_f64': lambda m, v: v['a'],
    'to_f64': lambda m, v: m.to_f64(m.sub(v['a'], v['b'])),
    'from_f32': lambda m, v: m.from_f32(v['f']),
    'sub_f': lambda m, v: m.sub_f(v['a'], v['f']),
    'const': lambda m, v: m.const(math.pi),
    'matvec3': lambda m, v: m.matvec3(v['m'], v['a'], v['b'], v['p']),
}
DSK_CASES = {
    **PAIR_CASES,
    'split_f64': lambda m, v: v['a'],
    'sqr': lambda m, v: m.sqr(v['a']),
    'mul_pair': lambda m, v: m.mul_pair(v['a'], m.const(math.pi)),
    # literals: numpy float32 in the JAX module, Python floats in the port
    'const': lambda m, v: tuple(np.float32(c) for c in m.const(math.pi)),
    'f': lambda m, v: np.float32(m.f(math.e)),
    'atan2': lambda m, v: m.atan2(v['f'], m.hi(v['b'])),
    'asin': lambda m, v: m.asin(v['f'] / 1e8),
    'acos': lambda m, v: m.acos(v['f'] / 1e8),
    'atan2_ds': lambda m, v: m.atan2_ds(v['a'], v['b']),
}
#: Cases held to float64 numpy at a grade: fn, reference, grade (relative)
DS_GRADED = {
    'rsqrt': (lambda m, v: m.rsqrt(v['p']), lambda x: 1.0 / np.sqrt(x['p']),
              DS_ROOT_GRADE),
    'sqrt': (lambda m, v: m.sqrt(v['p']), lambda x: np.sqrt(x['p']),
             DS_ROOT_GRADE),
}


def _run(module, j_module, fn, conv_seed=0):
    inputs = _inputs(np.random.default_rng(conv_seed))
    port = fn(module, _split_for(module, _torch, inputs))
    jax_ = fn(j_module, _split_for(j_module, _jax, inputs))
    return inputs, port, jax_


@pytest.mark.parametrize('name', DS_CASES)
def test_ds_matches_jax_word_for_word(name):
    _, port, jax_ = _run(ds, j_ds, DS_CASES[name])
    _assert_words_equal(port, jax_)


@pytest.mark.parametrize('name', DSK_CASES)
def test_dsk_matches_jax_word_for_word(name):
    _, port, jax_ = _run(dsk, j_dsk, DSK_CASES[name])
    _assert_words_equal(port, jax_)


def _split_exact(x):
    """float64 -> the value a ds pair holds (hi + lo)."""
    hi_ = x.astype(np.float32).astype(np.float64)
    return hi_ + (x - hi_).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize('module, j_module', [(ds, j_ds), (dsk, j_dsk)],
                         ids=['ds', 'dsk'])
@pytest.mark.parametrize('name', DS_GRADED)
def test_ds_roots_meet_the_grade_with_jax(module, j_module, name):
    fn, reference, grade = DS_GRADED[name]
    inputs, port, jax_ = _run(module, j_module, fn)
    want = reference({'p': _split_exact(inputs['p'])})
    for got in (port, jax_):
        assert np.max(np.abs(_f64(got) - want) / want) < grade


DS64_CASES = {
    'const': lambda m, v: m.const(math.pi),
    'from_f32': lambda m, v: m.from_f32(v['f']),
    'from_f64': lambda m, v: v['a'],
    'to_f64': lambda m, v: m.to_f64(v['a']),
    'hi': lambda m, v: m.hi(v['a']),
    'neg': lambda m, v: m.neg(v['a']),
    'add': lambda m, v: m.add(v['a'], v['b']),
    'sub': lambda m, v: m.sub(v['a'], v['b']),
    'add_f': lambda m, v: m.add_f(v['a'], v['f']),
    'sub_f': lambda m, v: m.sub_f(v['a'], v['f']),
    'mul': lambda m, v: m.mul(v['a'], v['b']),
    'mul_f': lambda m, v: m.mul_f(v['a'], v['f']),
    'recip': lambda m, v: m.recip(v['a']),
    'div': lambda m, v: m.div(v['a'], v['b']),
    'dot3': lambda m, v: m.dot3(v['a'], v['b'], v['p'], v['b'], v['p'],
                                v['a']),
    'matvec3': lambda m, v: m.matvec3(v['m'], v['a'], v['b'], v['p']),
}


@pytest.mark.parametrize('name', DS64_CASES)
def test_ds64_matches_jax_word_for_word(name):
    _, port, jax_ = _run(ds64, j_ds64, DS64_CASES[name])
    _assert_words_equal(port, jax_)


@pytest.mark.parametrize('name', ['rsqrt', 'sqrt'])
def test_ds64_roots_meet_the_grade_with_jax(name):
    inputs, port, jax_ = _run(ds64, j_ds64,
                              lambda m, v: getattr(m, name)(v['p']))
    want = np.sqrt(inputs['p'])
    if name == 'rsqrt':
        want = 1.0 / want
    for got in (port, jax_):
        assert np.max(np.abs(_f64(got) - want) / want) < DS64_ROOT_GRADE
    assert not np.any(_leaves(port)[1])  # the lo word is zero


FASTMATH_EXACT = {
    'recip64': lambda m, x: m.recip64(x['a']),
    'div64': lambda m, x: m.div64(x['a'], x['b']),
    'dot3': lambda m, x: m.dot3(x['v'], x['w']),
}
FASTMATH_GRADED = {
    'rsqrt64': (lambda m, x: m.rsqrt64(x['p']),
                lambda x: 1.0 / np.sqrt(x['p'])),
    'sqrt64': (lambda m, x: m.sqrt64(x['p']), lambda x: np.sqrt(x['p'])),
    'norm3_64': (lambda m, x: m.norm3_64(x['v']),
                 lambda x: np.linalg.norm(x['v'], axis=-1)),
    'normalize3_64': (
        lambda m, x: m.normalize3_64(x['v']),
        lambda x: x['v'] / np.linalg.norm(x['v'], axis=-1)[:, None]),
}


def _fastmath_inputs():
    x = _inputs(np.random.default_rng(3))
    rng = np.random.default_rng(4)
    x['v'] = rng.normal(size=(N, 3)) * 1e5
    x['w'] = rng.normal(size=(N, 3)) * 1e3
    return x


@pytest.mark.parametrize('name', FASTMATH_EXACT)
def test_fastmath_matches_jax_word_for_word(name):
    x = _fastmath_inputs()
    fn = FASTMATH_EXACT[name]
    _assert_words_equal(
        fn(fastmath, {k: _torch(v) for k, v in x.items()}),
        fn(j_fm, {k: _jax(v) for k, v in x.items()}))


@pytest.mark.parametrize('name', FASTMATH_GRADED)
def test_fastmath_meets_the_grade_with_jax(name):
    x = _fastmath_inputs()
    fn, reference = FASTMATH_GRADED[name]
    want = reference(x)
    for got in (fn(fastmath, {k: _torch(v) for k, v in x.items()}),
                fn(j_fm, {k: _jax(v) for k, v in x.items()})):
        err = np.abs(np.asarray(got) - want) / np.abs(want)
        assert np.max(err) < FASTMATH_GRADE


def _fastmath_domain(fm, scalar, vector):
    """tests/test_base.py:216 on either package."""
    assert np.isnan(float(fm.sqrt64(scalar(np.nan))))
    assert np.isnan(float(fm.rsqrt64(scalar(-1.0))))
    assert float(fm.sqrt64(scalar(-1.0))) == 0.0
    assert float(fm.sqrt64(scalar(1e40))) > 0.0  # finite, positive
    assert np.isfinite(float(fm.sqrt64(scalar(1e40))))
    assert np.isnan(float(fm.norm3_64(vector([1.0, np.nan, 2.0]))))
    assert float(fm.sqrt64(scalar(4.0))) == pytest.approx(2.0, rel=1e-14)


def test_fastmath_domain_contracts():
    _fastmath_domain(fastmath, lambda v: torch.tensor(v, dtype=torch.float64),
                     lambda v: torch.tensor(v, dtype=torch.float64))
    _fastmath_domain(j_fm, jnp.float64, jnp.array)


# ---------------------------------------------------------------------------
# The TestDskOnTpu cases through dsk_kernel's plain route
# ---------------------------------------------------------------------------

def _run_pairs(op, a64, b64):
    """tests/test_pallas_core.py:540 on CPU tensors: (hi + lo, hi) float64."""
    a = dsk.split_f64(torch.from_numpy(a64))
    b = dsk.split_f64(torch.from_numpy(b64))
    hi_, lo_ = dsk_kernel.pairs(op, a, b)
    return (hi_.double() + lo_.double()).numpy(), hi_.double().numpy()


@pytest.mark.parametrize('op', ['mul', 'div', 'hypot'])
def test_mul_div_sqrt_grade(op):
    """TestDskOnTpu.test_mul_div_sqrt_grade: 1e-13 relative."""
    a, b = dsk_cases.pair_inputs(op)
    assert a.size == 8 * 1024
    dsk_kernel.reset_launch_count()
    got, hi_only = _run_pairs(op, a, b)
    assert dsk_cases.error(op, got, a, b) < DS_ROOT_GRADE
    # the lo words carry the precision: hi alone is float32-grade
    assert dsk_cases.error(op, hi_only, a, b) > 1e4 * DS_ROOT_GRADE
    assert dsk_kernel.launch_count('dsk_pairs') == 0  # the plain route


def test_atan2_ds_grade():
    """TestDskOnTpu.test_atan2_ds_grade: 5e-12 rad."""
    y, x = dsk_cases.pair_inputs('atan2_ds')
    got, hi_only = _run_pairs('atan2_ds', y, x)
    assert dsk_cases.error('atan2_ds', got, y, x) < ATAN2_DS_GRADE
    assert dsk_cases.error('atan2_ds', hi_only, y, x) > 1e4 * ATAN2_DS_GRADE


def test_atan2_f32_grade():
    """TestDskOnTpu.test_atan2_f32_grade: 5e-7 rad on (8, 1024)."""
    y, x = (v.reshape(8, 1024) for v in dsk_cases.atan2_inputs())
    out = dsk_kernel.atan2(torch.from_numpy(y), torch.from_numpy(x))
    assert out.shape == (8, 1024) and out.dtype == torch.float32
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    assert np.max(np.abs(out.double().numpy() - ref)) < ATAN2_F32_GRADE
    _assert_words_equal(out, j_dsk.atan2(jnp.asarray(y), jnp.asarray(x)))
    assert dsk_kernel.launch_count('dsk_atan2') == 0


@pytest.mark.parametrize('op', ['mul', 'div', 'atan2_ds'])
def test_pair_cases_match_jax_word_for_word(op):
    """The cases' words against the JAX functions called eagerly (hypot's
    rsqrt seed differs: held to the grade above)."""
    a64, b64 = dsk_cases.pair_inputs(op)
    port = dsk_kernel.pairs(op, dsk.split_f64(torch.from_numpy(a64)),
                            dsk.split_f64(torch.from_numpy(b64)))
    fn = {'mul': j_dsk.mul, 'div': j_dsk.div, 'atan2_ds': j_dsk.atan2_ds}[op]
    _assert_words_equal(port, fn(j_dsk.split_f64(jnp.asarray(a64)),
                                 j_dsk.split_f64(jnp.asarray(b64))))


def _fma_two_prod(a, b):
    """The kernel's two_prod, p = a*b, e = fma(a, b, -p): a*b is exact in
    float64 (48 bits) and so is a*b - p, so one rounding to float32 is the
    FMA's."""
    p = a * b
    e = (a.double() * b.double() - p.double()).float()
    return p, e


@pytest.mark.parametrize('op', dsk_kernel.OPS)
def test_fma_two_prod_gives_the_plain_versions_words(op, monkeypatch):
    """csrc/dsk.cu computes two_prod with an FMA where ops/dsk.py splits
    (Dekker): on the cases' inputs every word is the same (for atan2_ds
    that is the plain version's chain; the kernel takes float64)."""
    a64, b64 = dsk_cases.pair_inputs(op)
    a = dsk.split_f64(torch.from_numpy(a64))
    b = dsk.split_f64(torch.from_numpy(b64))
    dekker = dsk_kernel.pairs_plain(op, a, b)
    monkeypatch.setattr(dsk, 'two_prod', _fma_two_prod)
    _assert_words_equal(dsk_kernel.pairs_plain(op, a, b), dekker)


# ---------------------------------------------------------------------------
# atan2_ds as the kernel computes it: native float64
# ---------------------------------------------------------------------------

#: The float64 route against float64 numpy: half an ulp of lo (|lo| <=
#: 2^-23 below |r| <= pi, so at most 2^-47 = 7.1e-15) and an ulp or two of
#: the float64 atan2s
SPLIT_ROUNDING = 1e-14


def _native(y64, x64):
    return dsk_kernel.atan2_ds_native(dsk.split_f64(torch.from_numpy(y64)),
                                      dsk.split_f64(torch.from_numpy(x64)))


@pytest.mark.parametrize('n', [dsk_cases.N_TEST, 65536])
def test_native_atan2_ds_meets_the_grade(n):
    """The float64 route on the seed-1 case, against float64 numpy: ~1e-14
    rad, set by the float32 rounding of lo; hi alone is float32-grade."""
    y, x = dsk_cases.pair_inputs('atan2_ds', n)
    hi_, lo_ = _native(y, x)
    assert hi_.dtype == lo_.dtype == torch.float32
    err = dsk_cases.error('atan2_ds', _f64((hi_, lo_)), y, x)
    assert err < ATAN2_DS_GRADE
    assert err < SPLIT_ROUNDING
    assert dsk_cases.error('atan2_ds', hi_.double().numpy(), y, x) > \
        1e4 * ATAN2_DS_GRADE


@pytest.mark.parametrize('n', [dsk_cases.N_TEST, 65536])
def test_native_atan2_ds_matches_jax_within_the_bar(n):
    """The float64 route against the JAX package's ds chain called eagerly
    (and the port's plain version, its word-for-word copy)."""
    y, x = dsk_cases.pair_inputs('atan2_ds', n)
    got = _f64(_native(y, x))
    jax_ = j_dsk.atan2_ds(j_dsk.split_f64(jnp.asarray(y)),
                          j_dsk.split_f64(jnp.asarray(x)))
    plain = dsk.atan2_ds(dsk.split_f64(torch.from_numpy(y)),
                         dsk.split_f64(torch.from_numpy(x)))
    _assert_words_equal(plain, jax_)
    assert np.max(np.abs(got - _f64(jax_))) < dsk_cases.ATAN2_DS_VS_PLAIN


@pytest.mark.parametrize('edge', dsk_cases.EDGES, ids=str)
def test_native_atan2_ds_keeps_the_ports_conventions(edge):
    """Every EDGES pair: a zero of either sign counts as +0 (atan2(-0, -1) =
    +pi, atan2(0, -0) = 0), NaN in either gives (NaN, NaN); on the axes,
    at the origin and at NaN the words equal dsk.atan2_ds's and the JAX
    package's; elsewhere within the bar."""
    y, x = (np.array([v]) for v in edge)
    got = _native(y, x)
    plain = dsk.atan2_ds(_pair(y), _pair(x))
    jax_ = j_dsk.atan2_ds(j_dsk.split_f64(jnp.asarray(y)),
                          j_dsk.split_f64(jnp.asarray(x)))
    _assert_words_equal(plain, jax_)
    ref = np.arctan2(0.0 if y[0] == 0 else y, 0.0 if x[0] == 0 else x)
    if np.isnan(ref).any():
        assert all(torch.isnan(t).all() for t in got)
        return
    assert abs(_f64(got) - ref)[0] < SPLIT_ROUNDING
    if dsk_cases.on_an_axis(*edge):
        _assert_words_equal(got, plain)
    else:
        assert abs(_f64(got) - _f64(plain))[0] < dsk_cases.ATAN2_DS_VS_PLAIN


def _cu_function(name: str) -> str:
    source = (Path(dsk.__file__).resolve().parent.parent / 'csrc' /
              'dsk.cu').read_text()
    start = source.index(f' {name}(')
    return source[start:source.index('\n}\n', start)]


@pytest.mark.parametrize('arg', ['y', 'x'])
def test_kernel_takes_zeros_as_the_port_does(arg):
    """csrc/dsk.cu's atan2_ds adds the pair in float64 and replaces a zero
    of either sign by +0 before its float64 atan2, as atan2_ds_native
    does; the ds tables it no longer needs are gone from the file."""
    body = _cu_function('atan2_ds')
    d = f'{arg}d'
    add = body.index(f'double {d} = (double){arg}.hi + (double){arg}.lo;')
    zero = body.index(f'{d} = {d} == 0.0 ? 0.0 : {d};')
    assert add < zero < body.index('atan2(yd, xd)')
    assert '__double2float_rn(r - (double)hi)' in body
    assert not {'kAtanDsHi', 'kAtanDsLo', 'kPi4', 'kPi2', 'kPi',
                'kTanPi8'} & set(_cu_constants())


# ---------------------------------------------------------------------------
# NaN and the edge cases
# ---------------------------------------------------------------------------

def _pair(values):
    return dsk.split_f64(torch.tensor(values, dtype=torch.float64))


@pytest.mark.parametrize('module', [ds, dsk], ids=['ds', 'dsk'])
def test_nan_propagates(module):
    split = getattr(module, 'split_f64', None) or module.from_f64
    nan = split(torch.tensor([np.nan], dtype=torch.float64))
    one = split(torch.tensor([1.0], dtype=torch.float64))
    for op in (module.add, module.sub, module.mul, module.div):
        assert torch.isnan(op(nan, one)[0]).all()
        assert torch.isnan(op(one, nan)[0]).all()
    for op in (module.recip, module.rsqrt, module.sqrt):
        assert torch.isnan(op(nan)[0]).all()
    if module is dsk:
        for op in (dsk.atan2_ds,):
            assert torch.isnan(torch.stack(op(nan, one))).all()
            assert torch.isnan(torch.stack(op(one, nan))).all()
        assert torch.isnan(dsk.atan2(nan[0], one[0])).all()
        assert torch.isnan(dsk.atan2(one[0], nan[0])).all()


def test_sqrt_and_recip_edge_cases():
    for module in (ds, dsk):
        split = getattr(module, 'split_f64', None) or module.from_f64
        hi_, lo_ = module.sqrt(split(torch.tensor([0.0, -1.0, np.nan, 4.0],
                                                  dtype=torch.float64)))
        assert hi_[0] == 0.0 and lo_[0] == 0.0
        assert torch.isnan(hi_[1:3]).all()
        assert hi_[3] == 2.0 and lo_[3] == 0.0
        # recip: zero gives NaN (callers clamp), a negative value its
        # negative reciprocal
        r = module.recip(split(torch.tensor([0.0, -4.0, 1e-30, 1e30],
                                            dtype=torch.float64)))
        assert torch.isnan(r[0][0])
        got = r[0][1:].double() + r[1][1:].double()
        assert torch.allclose(got, torch.tensor([-0.25, 1e30, 1e-30],
                                                dtype=torch.float64),
                              rtol=DS_ROOT_GRADE, atol=0.0)


def test_atan2_edge_cases():
    y = np.array([e[0] for e in dsk_cases.EDGES])
    x = np.array([e[1] for e in dsk_cases.EDGES])
    got = dsk.atan2(torch.from_numpy(y.astype(np.float32)),
                    torch.from_numpy(x.astype(np.float32)))
    _assert_words_equal(got, j_dsk.atan2(jnp.asarray(y, jnp.float32),
                                         jnp.asarray(x, jnp.float32)))
    got_ds = dsk.atan2_ds(_pair(y), _pair(x))
    _assert_words_equal(got_ds, j_dsk.atan2_ds(j_dsk.split_f64(jnp.asarray(
        y)), j_dsk.split_f64(jnp.asarray(x))))
    ref = np.arctan2(y, x)
    # a -0 y counts as +0 in both packages: atan2(-0, -1) is +pi there,
    # -pi in numpy
    ref[(y == 0) & (x < 0)] = np.pi
    ref[(y == 0) & (x == 0)] = 0.0
    nan = np.isnan(ref)
    assert nan.sum() == 2
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
    assert np.max(np.abs(got.double().numpy() - ref)[~nan]) < ATAN2_F32_GRADE
    assert np.max(np.abs(_f64(got_ds) - ref)[~nan]) < ATAN2_DS_GRADE


# ---------------------------------------------------------------------------
# Graph-level double-single without barriers
# ---------------------------------------------------------------------------

def test_ds_lo_words_survive_a_cancelling_chain():
    """ops/ds.py has no optimization barrier: eager PyTorch rounds each
    operation once, so a 1e9 - 1e9*(1 + 1e-9) chain keeps its lo words."""
    rng = np.random.default_rng(5)
    a = _sample(rng, lo=1e3, hi=1e9)
    b = -a * (1.0 + 1e-9)
    da, db = ds.from_f64(_torch(a)), ds.from_f64(_torch(b))
    assert (da[1] != 0).any()
    got = ds.to_f64(ds.add(da, db)).numpy()
    want = (ds.to_f64(da) + ds.to_f64(db)).numpy()
    assert np.max(np.abs(got - want) / np.abs(want)) < 2e-13
    # hi alone is float32: its error is far above the pair's
    naive = (da[0] + db[0]).double().numpy()
    assert np.max(np.abs(naive - want) / np.abs(want)) > 1e-3
    # ds.hi recovers the hi word exactly
    prod = ds.mul(da, da)
    assert torch.equal(ds.hi(prod), prod[0])


# ---------------------------------------------------------------------------
# pick_ds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('forced, expected', [
    (None, ds64), ('f64', ds64), ('ds', ds),
])
def test_pick_ds(monkeypatch, forced, expected):
    if forced is None:
        monkeypatch.delenv('PLANETMAPPER_TPU_DS', raising=False)
    else:
        monkeypatch.setenv('PLANETMAPPER_TPU_DS', forced)
    got = t_pipeline.pick_ds()
    assert got is expected
    assert got.__name__.startswith('planetmapper_tpu_torch.')
    # the JAX package picks the same backend on its CPU
    want = j_pipeline.pick_ds()
    assert want.__name__.rsplit('.', 1)[1] == got.__name__.rsplit('.', 1)[1]


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_wrapper_checks_its_inputs():
    a = _pair([1.0, 2.0])
    with pytest.raises(ValueError, match='op must be'):
        dsk_kernel.pairs('add', a, a)
    with pytest.raises(TypeError, match='float32'):
        dsk_kernel.pairs('mul', a, (a[0].double(), a[1]))
    with pytest.raises(ValueError, match='one shape'):
        dsk_kernel.pairs('mul', a, _pair([1.0]))
    meta = torch.empty(2, dtype=torch.float32, device='meta')
    with pytest.raises(ValueError, match='no dsk kernel'):
        dsk_kernel.atan2(meta, meta)
    with pytest.raises(ValueError, match='CUDA'):
        dsk_kernel.launch_atan2(a[0], a[0], a[0])
    with pytest.raises(ValueError, match='CUDA'):
        dsk_kernel.launch_pairs('mul', *a, *a, *a)
    with pytest.raises(ValueError, match='op must be'):
        dsk_kernel.pairs_plain('add', a, a)


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('op, words, ops', [
    ('mul', 6, 10), ('div', 6, 22), ('hypot', 6, 54), ('atan2_ds', 6, 321),
    ('atan2', 3, 29),
])
def test_dsk_bound_counts_the_function(op, words, ops):
    n = 2048 * 2048
    branches = dict(swapped=1000, negative_x=2000, reduced=3000)
    got = bounds.dsk_call_bound(op, n, **branches)
    extra = {'atan2_ds': 11 * 3000 + 53 * 3000, 'atan2': 3000}.get(op, 0)
    assert got['f32_ops'] == ops * n + extra
    assert got['bytes'] == 4 * words * n
    t_bytes = got['bytes'] / 3.35e12
    t_ops = got['f32_ops'] / 67e12
    assert got['ms'] == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert got['bound_by'] == ('bytes' if t_bytes >= t_ops else 'operations')
    with pytest.raises(ValueError):
        bounds.dsk_call_bound('add', n)


def test_atan2_branches_counts_the_kernels_tests():
    y = np.array([0.0, 1.0, -1.0, 0.3, 2.0, np.nan], np.float32)
    x = np.array([1.0, 0.5, -1.0, -1.0, -0.1, 1.0], np.float32)
    # |y| > |x|: (1, 0.5) and (2, -0.1); x < 0: three; min/max above
    # tan(pi/8): 0.5 and 1 (a NaN compares False everywhere)
    assert bounds.atan2_branches(y, x) == dict(swapped=2, negative_x=3,
                                               reduced=2)
