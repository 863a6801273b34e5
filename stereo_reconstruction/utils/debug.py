"""Numeric sanitizers: the framework's answer to TSan/ASan (SURVEY §5).

The reference has no sanitizers or runtime guards at all (no TSan/ASan in
src/CMakeLists.txt; errors are bare ``throw std::runtime_error``). Here the
equivalent for an XLA program is `jax.experimental.checkify`:

  * ``checked(fn)`` — wrap a jittable function so NaN/Inf production,
    out-of-bounds gathers, and explicit ``guard_*`` checks inside it
    become Python ``CheckError``s instead of silent garbage;
  * ``guard_finite(x, name)`` / ``guard(pred, msg)`` — checks that are
    free when the function is NOT run under ``checked`` (they lower to
    no-ops outside checkify), so hot kernels can keep guards in place.

Usage:
    from stereo_reconstruction.utils import debug
    safe = debug.checked(my_jitted_fn)
    out = safe(*args)          # raises CheckError on NaN/OOB

Determinism note: the framework seeds every stochastic component
(jax.random keys from config.seed; fixed BRIEF pattern seed) — replacing
the reference's ``std::random_device`` (eight_point.cpp:243) and
``clock()`` seeding (rectification.cpp:591).
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable

import jax
from jax.experimental import checkify

# set (at trace time) while a function runs under ``checked`` — guards are
# plain Python no-ops otherwise, so hot kernels can keep them in place
_ACTIVE = contextvars.ContextVar("stpu_checkify_active", default=False)

# float_checks: every primitive that produces NaN/Inf errors out.
# index_checks: OOB gather/scatter (the XLA clamp would otherwise hide it).
# user_checks: explicit guard()/guard_finite() calls.
FULL_CHECKS = checkify.float_checks | checkify.index_checks | checkify.user_checks
USER_CHECKS = checkify.user_checks


def guard(pred, msg: str, **fmt) -> None:
    """Explicit invariant check. No-op unless running under ``checked``
    (a bare ``checkify.check`` cannot be staged through jit without the
    checkify transform, so guards vanish at trace time when disabled)."""
    if _ACTIVE.get():
        checkify.check(pred, msg, **fmt)


def guard_finite(x, name: str = "value") -> None:
    """Assert every element of ``x`` is finite (catches the classic cost-
    volume failure mode: a NaN window cost poisoning the argmin)."""
    import jax.numpy as jnp

    if _ACTIVE.get():
        checkify.check(jnp.isfinite(x).all(), f"{name} contains NaN/Inf")


def checked(fn: Callable, errors=USER_CHECKS, jit: bool = True) -> Callable:
    """Wrap ``fn`` so checkify errors raise ``checkify.JaxRuntimeError``.

    ``errors=FULL_CHECKS`` additionally instruments every float op and
    gather — the debug mode; default instruments only explicit guards.
    NB: FULL_CHECKS trips on *intentional* non-finite sentinels (the cost
    volumes use +inf = invalid candidate by convention), so it is meant
    for kernels that should be sentinel-free end-to-end.
    """
    @functools.wraps(fn)
    def activated(*args, **kwargs):
        token = _ACTIVE.set(True)
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)

    cfn = checkify.checkify(activated, errors=errors)
    if jit:
        cfn = jax.jit(cfn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapper
