"""A fixture for the port's test modules that run the JAX package's fused
programs without x64 (``jax.enable_x64(False)``, as the JAX CLIs run).

Such a module compiles each program a second time, beside the x64
variants the other tests compile, and an xdist worker keeps every compiled
program alive until it exits.  After enough of them, one worker's next
large compilation died in XLA's executable serialization (the persistent
compilation cache's write, or its read: SIGABRT / SIGSEGV in
``tests/test_checkpoint.py``, which ran after ``test_torch_offline.py``,
``test_torch_loop_e2e.py`` and ``test_torch_fused_keys.py`` in one
process), and xdist then waited on the dead worker.  Releasing a module's
programs when it ends (``jax.clear_caches()``) kept that sequence
whole; later modules reload what they need from the persistent cache.

Import it into a test module to apply it to every test there:

    from jax_programs import release_jax_programs  # noqa: F401
"""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_programs():
    """Drop the JAX programs the module compiled once its tests end."""
    yield
    jax.clear_caches()
