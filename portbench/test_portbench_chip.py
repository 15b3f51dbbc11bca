"""On the card: one short run of a cell, and one with its control in the
program's place; skips here."""
import time

import pytest

from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's Hopper kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_paper_cell_correct_and_control_not(card, control):
    from portbench import harness
    res, _ = harness.run("deepseek-moe-16b.paper.poisson", 2**32 + 3, 10.0,
                         False, t_process=time.perf_counter(),
                         control=control)
    assert res["correct"] is (not control), res["checks"]
