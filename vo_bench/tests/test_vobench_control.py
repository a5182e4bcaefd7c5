"""The control on the card: the reference in bfloat16 put in the program's
place must fail a cell's limits where the program, on the same frames,
passes them.  Run on a GPU with

    python -m pytest -m cuda vo_bench/tests/test_vobench_control.py

(each cell at its own size, a 3-second window and 24 samples; about a
minute a cell).  Without a card it skips."""

import pytest
import torch

import control
import harness
import judge


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_control_fails_where_the_program_passes(cuda_device, cell):
    limits = harness.load_json("limits", cell)
    program, lower = control.readings(cell, 2**31 + 17, 3.0, cuda_device, samples=24)
    assert judge.verdict(program, limits), program
    assert not judge.verdict(lower, limits), lower
