"""The port's profiling entry point (``ljmd_tpu_torch/utils/profiling.py``):
the interval union behind its device busy time, and its refusal to run
without a card."""

import os

import pytest
import torch

from ljmd_tpu_torch.utils import profiling

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),          # overlap
    ([(4.0, 5.0), (0.0, 1.0), (0.5, 0.75)], 2.0),  # unsorted, nested
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),          # touching
])
def test_merged_length_is_the_union(intervals, length):
    assert profiling._merged_length(intervals) == pytest.approx(length)


def test_profiling_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        profiling.main(["--config", os.path.join(EXAMPLES, "n864_liquid.json"),
                        "--total-steps", "10"])
