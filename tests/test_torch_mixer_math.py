"""K4's scalar math (csrc/mixer_math.cuh), compiled by g++ into a CPU
library, against the JAX package's mixer functions over dense grids.

Tolerance: the arithmetic (the smoothers, the knee curve, the crowd gain)
is exact, since the header rounds every product and sum separately in
float32 as the reference does; the functions built on powf, log10f and tanhf
are held within 4 units in the last place, the spread between libm's float32
transcendentals and XLA's own."""

import ctypes

import numpy as np
import pytest

import jax.numpy as jnp

from asciichat_tpu.ops import audio as jaudio
from asciichat_tpu_torch.ops import audio as taudio
from asciichat_tpu_torch.runtime import kernel_build

P = jaudio.MixerParams()
MAX_ULP = 4


@pytest.fixture(scope="module")
def lib():
    return kernel_build.mixer_math_lib()


@pytest.fixture(scope="module")
def consts() -> np.ndarray:
    return taudio.mixer_consts(taudio.MixerParams())


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _unary(lib, fn: str, x: np.ndarray, *extra) -> np.ndarray:
    out = np.empty_like(x)
    getattr(lib, fn)(_ptr(x), len(x), *extra, _ptr(out))
    return out


def test_consts_layout_matches(lib, consts):
    assert lib.mm_consts_count() == len(taudio.MIXER_CONSTS) == len(consts)
    assert consts.dtype == np.float32 and not consts.flags.writeable


def test_db_to_linear_dense(lib):
    db = np.linspace(-140.0, 40.0, 200_001, dtype=np.float32)
    np.testing.assert_array_max_ulp(_unary(lib, "mm_db_to_linear", db),
                                    np.asarray(jaudio.db_to_linear(jnp.asarray(db))), MAX_ULP)


def test_linear_to_db_dense(lib):
    x = np.concatenate([np.logspace(-15, 2, 200_001).astype(np.float32),
                        np.float32([0.0, -1.0, 1e-12, 1.0])])
    got = _unary(lib, "mm_linear_to_db", x)
    np.testing.assert_array_max_ulp(got, np.asarray(jaudio.linear_to_db(jnp.asarray(x))),
                                    MAX_ULP)
    assert got[-1] == 0.0 and got[-4] == got[-3] == got[-2]  # floor at 1e-12


@pytest.mark.parametrize("fn,ref", [("mm_attack_release", jaudio._attack_release),
                                    ("mm_gain_smooth", jaudio._gain_smooth)])
@pytest.mark.parametrize("which", ["duck", "comp"])
def test_smoothers_exact(lib, fn, ref, which):
    rng = np.random.default_rng(11)
    value = (rng.random(200_000) * 2).astype(np.float32)
    target = (rng.random(200_000) * 2).astype(np.float32)
    target[:1000] = value[:1000]  # equal level: the release branch
    att, rel = ((P.duck_attack_coeff, P.duck_release_coeff) if which == "duck"
                else (P.comp_attack_coeff, P.comp_release_coeff))
    got = np.empty_like(value)
    getattr(lib, fn)(_ptr(value), _ptr(target), len(value), att, rel, _ptr(got))
    want = ref(jnp.asarray(value), jnp.asarray(target), att, rel)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_gain_reduction_exact(lib, consts):
    level = np.linspace(-60.0, 20.0, 100_001, dtype=np.float32)  # through the knee
    got = _unary(lib, "mm_gain_reduction_db", level, _ptr(consts))
    want = jaudio._compressor_gain_reduction_db(P, jnp.asarray(level))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_crowd_gain_exact(lib, consts):
    count = np.arange(0, 33, dtype=np.float32)
    c = jnp.asarray(count)
    want = P.base_gain * jnp.where(c > 0, 1.0 / jnp.power(jnp.maximum(c, 1.0), P.crowd_alpha),
                                   1.0)
    np.testing.assert_array_equal(_unary(lib, "mm_crowd_gain", count, _ptr(consts)),
                                  np.asarray(want))


def test_soft_clip_dense(lib, consts):
    x = np.linspace(-4.0, 4.0, 400_001, dtype=np.float32)
    got = _unary(lib, "mm_soft_clip", x, _ptr(consts))
    want = np.asarray(jaudio.soft_clip(jnp.asarray(x), P.clip_threshold, P.clip_steepness))
    np.testing.assert_array_max_ulp(got, want, MAX_ULP)


def test_soft_clip_keeps_the_sign_defect(lib, consts):
    x = np.float32([-1.0, -0.7, 0.7, 1.0])
    got = _unary(lib, "mm_soft_clip", x, _ptr(consts))
    # +-threshold passes through; x = -1.0 folds back toward -threshold
    # (mixer.c:1030-1041's (-1.0 + threshold) coefficient), x = 1.0 does not
    np.testing.assert_allclose(got, [-0.7 + 0.3 * np.tanh(0.9), -0.7, 0.7,
                                     0.7 + 0.3 * np.tanh(0.9)], rtol=1e-6)
    assert got[0] > -0.7
