"""Run-wide test set-up: one XLA compilation cache a run, a scheduler for
``--dist loadfile``, and a wall limit on every phase of every test.

Compilation cache.  ``tests/conftest.py`` drops the in-memory jit caches
at every module boundary, so without a disk cache each module, on each
xdist worker, compiles the same tracker, window and solver programs
again.  Here the run's first process (the xdist controller, or the only
process) makes a fresh directory, hands it to its workers through xdist's
``workerinput`` and removes it when the run ends.  Every run starts cold,
and nothing outside the run can choose the directory.  A run that is
killed leaves its directory in the temp dir.

Scheduler.  Under ``--dist loadfile`` a test file that predates the port
(``tests/test_*.py`` not named ``test_torch_*``) is one work unit per test
function, its parametrised cases together; every other file is one unit,
so a port file builds its module-scoped JAX references once.  The
function units go out first, in collection order, then the whole files,
most tests first.  A worker gets its next unit only when at most one of
its tests is pending, the one it needs to know its next item.

Limit.  Setup, call and teardown of every test each have
``PER_TEST_LIMIT_S`` seconds of wall time; a phase that overruns fails its
test, and the run goes on.  It runs on ``SIGALRM`` in the main thread
(where xdist runs its tests) and does nothing where that is missing.
"""

import contextlib
import re
import shutil
import signal
import tempfile
import threading

import pytest

_cache_dir = pytest.StashKey[str]()
_WORKER_KEY = "jax_compilation_cache_dir"

PER_TEST_LIMIT_S = 600
_PRE_PORT_FILE = re.compile(r"tests/test_(?!torch_)[^/]*\.py")


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


def work_unit(nodeid):
    """The scheduler's unit of ``nodeid``: its test function in a file
    that predates the port, else its file."""
    path, _, name = nodeid.partition("::")
    if name and _PRE_PORT_FILE.fullmatch(path):
        return f"{path}::{name.split('[', 1)[0]}"
    return path


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class FunctionUnitScheduling(LoadFileScheduling):
        _ordered = False

        def _split_scope(self, nodeid):
            return work_unit(nodeid)

        def _assign_work_unit(self, node):
            if not self._ordered:  # the first hand-out sees the whole queue
                self._ordered = True
                first = {}
                for index, nodeid in enumerate(self.collection):
                    first.setdefault(work_unit(nodeid), index)

                def rank(unit):
                    scope, tests = unit
                    return (0, first[scope]) if "::" in scope else (1, -len(tests), first[scope])

                units = sorted(self.workqueue.items(), key=rank)
                self.workqueue.clear()
                self.workqueue.update(units)
            super()._assign_work_unit(node)

        def _reschedule(self, node):
            if node.shutting_down:
                return
            if not self.workqueue:
                node.shutdown()
                return
            if self._pending_of(self.assigned_work[node]) > 1:
                return
            self._assign_work_unit(node)

    return FunctionUnitScheduling(config, log)


@contextlib.contextmanager
def _phase_limit(phase):
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        yield
        return

    def overrun(signum, frame):
        pytest.fail(f"exceeded the per-test limit of {PER_TEST_LIMIT_S} s in its {phase} phase", pytrace=False)

    previous = signal.signal(signal.SIGALRM, overrun)
    signal.setitimer(signal.ITIMER_REAL, PER_TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    with _phase_limit("setup"):
        return (yield)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_call(item):
    with _phase_limit("call"):
        return (yield)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_teardown(item, nextitem):
    with _phase_limit("teardown"):
        return (yield)
