"""On the card: both tiny cells traced, correct, every roofline share
found at most 100%, the device busy inside the window. Skips where there
is no CUDA device."""
import pytest

from perfbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-blobs.hybrid", "tiny-text.serve"])
def test_tiny_cell_traced_on_the_card(bench, card, cell):
    path, dirs = bench
    out, code = harness.run(cell, 9, 2.0, True, device=card,
                            benchmark=path, dirs=dirs)
    assert code == 0 and out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100
