"""checkify-based numeric sanitizers (utils/debug.py, SURVEY §5)."""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import checkify

from stereo_reconstruction.utils import debug


def test_guard_raises_under_checked():
    def f(x):
        debug.guard((x > 0).all(), "x must be positive")
        return jnp.sqrt(x)

    safe = debug.checked(f)
    np.testing.assert_allclose(safe(jnp.array([4.0])), [2.0])
    with pytest.raises(checkify.JaxRuntimeError, match="positive"):
        safe(jnp.array([-1.0]))


def test_guard_is_noop_outside_checked():
    import jax

    def f(x):
        debug.guard(jnp.array(False), "never raises outside checkify")
        return x * 2

    np.testing.assert_allclose(jax.jit(f)(jnp.array([3.0])), [6.0])


def test_guard_finite():
    def f(x):
        y = x - 1.0
        debug.guard_finite(y, "y")
        return y

    safe = debug.checked(f)
    safe(jnp.ones(4))
    with pytest.raises(checkify.JaxRuntimeError, match="NaN/Inf"):
        safe(jnp.array([jnp.inf, 1.0, 2.0, 3.0]))


def test_full_checks_catch_nan_production():
    def f(x):
        return jnp.log(x)          # log(-1) -> NaN

    safe = debug.checked(f, errors=debug.FULL_CHECKS)
    safe(jnp.array([1.0, 2.0]))
    with pytest.raises(checkify.JaxRuntimeError, match="nan"):
        safe(jnp.array([-1.0]))
