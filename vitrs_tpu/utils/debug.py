"""Numerical-safety tooling — the JAX equivalent of sanitizers
(SURVEY.md §5.2): JAX's pure-functional model rules out data races by
construction; what remains is NaN/Inf detection and guarded train steps.

The reference has ~470 LoC of unsafe aliasing pointer kernels and no
sanitizer; here `debug_mode()` turns on jax_debug_nans globally and
`checked(fn)` wraps a step function with checkify so NaN/OOB surface as
structured errors instead of silent garbage."""

from __future__ import annotations

import contextlib
from typing import Callable

import jax
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Context manager: re-run-and-raise on the first NaN-producing op."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", nans)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def checked(fn: Callable, *, jit: bool = True) -> Callable:
    """Wrap fn with checkify float checks (NaN/Inf) + index OOB checks.
    Returns a callable that raises checkify.JaxRuntimeError on violation."""
    errs = checkify.float_checks | checkify.index_checks
    cfn = checkify.checkify(fn, errors=errs)
    if jit:
        cfn = jax.jit(cfn)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def global_norm(tree) -> jax.Array:
    """L2 norm over a pytree — the grad-norm metric (SURVEY.md §5.5)."""
    import jax.numpy as jnp
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.sqrt(sum(jnp.sum(jnp.square(l.astype(jnp.float32)))
                        for l in leaves))
