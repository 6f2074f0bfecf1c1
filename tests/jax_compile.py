"""How the port's tests (``tests/test_torch_*.py``) compile their JAX
references more cheaply; a helper module, not a test module.

- ``FAST_COMPILE``: XLA's cheaper passes as ``compiler_options`` of one
  ``jax.jit`` (the references compile in about half the time);
- ``fast_jit()``: a context in which every ``jax.jit`` gets them, for JAX
  steps that jit themselves while they are built;
- ``_cheap_xla``: a module fixture (import it into a test module to use it)
  that sets ``jax_disable_most_optimizations`` for every JAX compile of the
  module, eager operations and the JAX package's own jits included, and
  afterwards drops the programs compiled so, so that no later module reuses
  them.
"""

import contextlib
import functools

import jax
import pytest

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn, **kwargs):
    """``jax.jit(fn)`` compiled with FAST_COMPILE."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kwargs)


@contextlib.contextmanager
def fast_jit():
    """``jax.jit`` with FAST_COMPILE while a JAX step is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        yield


@pytest.fixture(scope="module", autouse=True)
def _cheap_xla():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)
    jax.clear_caches()
