"""Run-wide test set-up: one persistent XLA compilation cache per run.

``tests/conftest.py`` drops the in-memory jit caches at every module
boundary, so without a disk cache each module, on each xdist worker,
compiles the same tracker, window and solver programs again.  Here the
run's first process (the xdist controller, or the only process) makes a
fresh directory, hands it to its workers through xdist's ``workerinput``
and removes it when the run ends.  Every run starts cold, and nothing
outside the run can choose the directory.  A run that is killed leaves
its directory in the temp dir.
"""

import shutil
import tempfile

import pytest

_cache_dir = pytest.StashKey[str]()
_WORKER_KEY = "jax_compilation_cache_dir"


def pytest_configure(config):
    try:
        import jax
    except ImportError:  # the port's own tests also run where JAX is absent
        return
    workerinput = getattr(config, "workerinput", None)
    if workerinput is None:
        path = tempfile.mkdtemp(prefix="jax-cache-")
        config.stash[_cache_dir] = path
    else:
        path = workerinput[_WORKER_KEY]
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    if _cache_dir in node.config.stash:
        node.workerinput[_WORKER_KEY] = node.config.stash[_cache_dir]


def pytest_unconfigure(config):
    if _cache_dir in config.stash:
        shutil.rmtree(config.stash[_cache_dir], ignore_errors=True)
