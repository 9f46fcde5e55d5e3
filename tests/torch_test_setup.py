"""Test helper of the port's modules that run the reference (JAX):

* the reference's compiled XLA programs go to JAX's persistent
  compilation cache, a directory shared by every test process, so a
  program that several modules (or several servers of one module)
  compile is compiled once a run and loaded from the cache after that;
* the port's own CPU work runs on one thread a process: the test
  shapes are tiny, and six test workers with a thread pool each as wide
  as the machine only wake and spin those threads against each other;
* `release_compiled_programs`, the module fixture that drops each
  module's compiled programs when it ends.

Every test worker imports each test module when it collects the suite,
so the first module that imports this helper sets both for the whole
process. The cache holds programs only: a program loaded from it runs
as the one compiled in place would. Its directory lies under the
temporary directory (`tempfile.gettempdir()`, so TMPDIR)."""

import gc
import os
import tempfile

import jax
import pytest
import torch

CACHE_DIR = os.path.join(tempfile.gettempdir(),
                         "cloud_server_tpu_torch_tests_jax_cache")


def enable() -> None:
    """Turn the persistent compilation cache on for this process (every
    program, however quick its compile); a no-op once a directory is
    set."""
    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


enable()
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and a test worker that runs several
    reference-heavy modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails. With the cache on,
    a later module that needs one of them loads it instead of compiling
    it again. Import it into a module to use it there."""
    yield
    jax.clear_caches()
    gc.collect()
