"""The repo-root ``conftest.py``'s scheduler and per-test limit, on a tiny
suite in a pytest subprocess: the root conftest's hooks with a 1 s limit,
one file named like a file that predates the port and one port file."""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import threading
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
LIMIT = "PER_TEST_LIMIT_S = 600\n"

_PRE_PORT = """
import time

import pytest


@pytest.fixture
def slow_setup():
    time.sleep(60)


@pytest.fixture
def slow_teardown():
    yield
    time.sleep(60)


def test_one():
    time.sleep(0.3)


def test_two():
    time.sleep(0.3)


@pytest.mark.parametrize("case", range(4))
def test_cases(case):
    time.sleep(0.3)


def test_three():
    time.sleep(0.3)


def test_overruns_call():
    time.sleep(60)


def test_overruns_setup(slow_setup):
    pass


def test_overruns_teardown(slow_teardown):
    pass
"""

_PORT = """
import time


def test_a():
    time.sleep(0.2)


def test_b():
    time.sleep(0.2)


def test_c():
    time.sleep(0.2)
"""

_LINE = re.compile(r"^\[(gw\d+)\] \[\s*\d+%\] (PASSED|FAILED|ERROR) (\S+)", re.M)


class _Config:
    option = types.SimpleNamespace(loadscopereorder=True)

    def getvalue(self, name):
        return {"dist": "loadfile", "tx": ["2*popen"]}[name]


class _Node:
    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", REPO / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny suite under ``-n 2 --dist loadfile``: each test's worker
    and outcomes, and the run's output."""
    pytest.importorskip("xdist")
    root = tmp_path_factory.mktemp("suite")
    conftest = (REPO / "conftest.py").read_text()
    assert LIMIT in conftest
    (root / "conftest.py").write_text(conftest.replace(LIMIT, "PER_TEST_LIMIT_S = 1\n"))
    (root / "pytest.ini").write_text("[pytest]\n")
    (root / "tests").mkdir()
    (root / "tests" / "test_alpha.py").write_text(_PRE_PORT)
    (root / "tests" / "test_torch_beta.py").write_text(_PORT)
    (root / "nojax" / "jax").mkdir(parents=True)  # as on the card, and each process starts faster
    (root / "nojax" / "jax" / "__init__.py").write_text("raise ImportError('no JAX in this run')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(root / "nojax"), env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-p", "xdist", "-n", "2", "--dist", "loadfile", "-v",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-rfE"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120,
    )
    workers, outcomes = {}, {}
    for worker, outcome, nodeid in _LINE.findall(proc.stdout):
        workers[nodeid] = worker
        outcomes.setdefault(nodeid, []).append(outcome)
    return proc, workers, outcomes


def test_pre_port_file_runs_a_function_a_unit_on_both_workers(tiny_run):
    proc, workers, _ = tiny_run
    alpha = {w for nodeid, w in workers.items() if nodeid.startswith("tests/test_alpha.py::")}
    assert alpha == {"gw0", "gw1"}, proc.stdout


def test_parametrised_cases_share_a_worker(tiny_run):
    proc, workers, _ = tiny_run
    cases = [w for nodeid, w in workers.items() if nodeid.startswith("tests/test_alpha.py::test_cases[")]
    assert len(cases) == 4 and len(set(cases)) == 1, proc.stdout


def test_port_file_stays_on_one_worker(tiny_run):
    proc, workers, _ = tiny_run
    beta = [w for nodeid, w in workers.items() if nodeid.startswith("tests/test_torch_beta.py::")]
    assert len(beta) == 3 and len(set(beta)) == 1, proc.stdout


@pytest.mark.parametrize("phase", ["setup", "call", "teardown"])
def test_overrun_fails_its_test_alone(tiny_run, phase):
    proc, _, outcomes = tiny_run
    nodeid = f"tests/test_alpha.py::test_overruns_{phase}"
    assert ("FAILED" if phase == "call" else "ERROR") in outcomes[nodeid], proc.stdout
    assert f"exceeded the per-test limit of 1 s in its {phase} phase" in proc.stdout, proc.stdout
    others = [o for n, o in outcomes.items() if "overruns" not in n]
    assert len(others) == 10 and all(o == ["PASSED"] for o in others), proc.stdout


def test_scheduler_orders_units_and_hands_out_at_one_pending():
    """Function units first in collection order, then whole files by test
    count; a worker gets a unit only when one test or none is pending."""
    pytest.importorskip("xdist")
    f1a, f1b, f2, f3, f4 = ("tests/test_x.py::f1[0]", "tests/test_x.py::f1[1]", "tests/test_x.py::f2",
                            "tests/test_x.py::f3", "tests/test_x.py::f4")
    collection = ["tests/test_torch_p.py::a", "tests/test_torch_p.py::b", "tests/test_torch_q.py::a",
                  f1a, f1b, f2, f3, f4, "tests/test_torch_r.py::a", "tests/test_torch_r.py::b", "tests/test_torch_r.py::c"]
    sched = _root_conftest().pytest_xdist_make_scheduler(config=_Config(), log=None)
    gw0, gw1 = _Node("gw0"), _Node("gw1")
    for node in (gw0, gw1):
        sched.add_node(node)
    for node in (gw0, gw1):
        sched.add_node_collection(node, collection)
    sched.schedule()

    def sent(node):
        return [collection[i] for i in node.sent]

    def done(node, nodeid):
        sched.mark_test_complete(node, collection.index(nodeid))

    assert sent(gw0) == [f1a, f1b] and sent(gw1) == [f2, f3]
    done(gw0, f1a)
    assert sent(gw0) == [f1a, f1b, f4]
    done(gw1, f2)
    assert sent(gw1)[2:] == ["tests/test_torch_r.py::a", "tests/test_torch_r.py::b", "tests/test_torch_r.py::c"]
    done(gw0, f1b)
    assert sent(gw0)[3:] == ["tests/test_torch_p.py::a", "tests/test_torch_p.py::b"]
    done(gw0, f4)
    assert len(gw0.sent) == 5
    done(gw0, "tests/test_torch_p.py::a")
    assert sent(gw0)[5:] == ["tests/test_torch_q.py::a"] and not gw0.shutting_down
    done(gw1, f3)
    assert gw1.shutting_down and len(gw1.sent) == 5


@pytest.mark.parametrize(("nodeid", "unit"), [
    ("tests/test_cli.py::test_cli_track[fr1-3]", "tests/test_cli.py::test_cli_track"),
    ("tests/test_parallel.py::test_eight_virtual_devices", "tests/test_parallel.py::test_eight_virtual_devices"),
    ("tests/test_cli.py::Group::test_case[a]", "tests/test_cli.py::Group::test_case"),
    ("tests/test_torch_batch.py::test_batch_matches[2]", "tests/test_torch_batch.py"),
    ("vo_bench/tests/test_vobench_spans.py::test_spans", "vo_bench/tests/test_vobench_spans.py"),
    ("tests/test_cli.py", "tests/test_cli.py"),
])
def test_work_unit_names_the_rule(nodeid, unit):
    assert _root_conftest().work_unit(nodeid) == unit


def test_the_rule_splits_the_31_files_that_predate_the_port():
    work_unit = _root_conftest().work_unit
    split = [p.name for p in sorted((REPO / "tests").glob("test_*.py")) if "::" in work_unit(f"tests/{p.name}::t")]
    assert len(split) == 31 and not any(name.startswith("test_torch_") for name in split), split


def test_root_conftest_imports_no_xdist_and_no_jax():
    """``pytest vo_bench/tests`` and a plain ``pytest`` load the root
    conftest too: importing it brings in neither xdist nor JAX."""
    program = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('root_conftest', {str(REPO / 'conftest.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('xdist', 'jax', 'torch')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", program], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_limit_does_nothing_off_the_main_thread():
    module = _root_conftest()
    seen = []

    def run():
        with module._phase_limit("call"):
            seen.append("ran")

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=30)
    assert seen == ["ran"]
