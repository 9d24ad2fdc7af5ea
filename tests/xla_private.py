"""A module fixture for the port's tests that run the reference's jitted
programs: they compile without JAX's on-disk compilation cache, the
programs they compiled are released when the module ends, and the
process's cache settings are restored.

The reference turns that cache on in any process that builds one of its
codecs or batchers (``ceph_tpu/ops/compile_cache.py``), and its tests, in
other test processes, compile the same programs into the same directory.
An entry is written in place, so a process that reads it while another
writes it can crash.  Under this fixture a port module neither reads nor
writes the directory, and leaves the settings of the test files that run
after it in the same process as it found them.

Every compiled CPU program keeps memory mappings for its code, and a
process may hold at most ``vm.max_map_count`` (65530 by default) of
them: a test process that kept every program of a port module alive and
then ran the reference's daemon tests ran out and crashed.  So the
module's programs are dropped from JAX's caches at its end (a module
that keeps programs itself releases them in its own fixture)."""

import gc

import jax
import pytest

_CACHE_KEYS = ("jax_enable_compilation_cache", "jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(autouse=True, scope="module")
def _private_xla_compiles():
    from jax.experimental.compilation_cache import compilation_cache as xla_cache

    from ceph_tpu.ops import compile_cache

    was = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
    done = compile_cache._done
    jax.config.update("jax_enable_compilation_cache", False)
    xla_cache.reset_cache()
    yield
    gc.collect()
    jax.clear_caches()
    for key, value in was.items():
        jax.config.update(key, value)
    compile_cache._done = done
    xla_cache.reset_cache()
