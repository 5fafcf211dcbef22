"""Keep the reference's compiled-program caches as a port test file
found them.

``repro.core.engine._STEP_CACHE`` and ``repro.core.sweep._SWEEP_CACHE``
live for the whole process and hold one jitted program per static key.
A port test file that drives the reference's engine or sweep fills them;
a reference test file that runs after it in the same process (under
``pytest -n ... --dist loadfile``) would then find a program already
traced at other shapes, and its ``_cache_size() == 1`` checks would read
2. Importing the fixture below into a test module makes it autouse for
that module: the entries the module added are dropped when it ends.
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def reference_program_caches():
    from repro.core import engine, sweep
    caches = (engine._STEP_CACHE, sweep._SWEEP_CACHE)
    saved = [dict(c) for c in caches]
    yield
    for cache, old in zip(caches, saved):
        cache.clear()
        cache.update(old)
