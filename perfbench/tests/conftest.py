import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); "
        "skips where there is none")


@pytest.fixture
def bench(tmp_path):
    """(BENCHMARK.json of the tiny cells, the directories to search)."""
    import torch

    from perfbench import spec
    from perfbench.tests import tiny
    torch.set_num_threads(1)
    return tiny.write(str(tmp_path)), [str(tmp_path), spec.PKG]
