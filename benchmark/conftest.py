"""pytest settings of the benchmark's own tests (``benchmark/tests``):
the harness's folder and the checkout's root on the import path, the
``card`` marker, and the fixtures the tests share.

Tests marked ``card`` need a CUDA device; they decide inside the ``card``
fixture whether one exists, and skip on the CPU.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips on the CPU)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    return torch.device("cuda:0")


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """``make_tiny_root`` in a temporary directory, with the program's
    instance-cap probe cut to the tiny size and torch on few threads."""
    import torch
    from tinycell import make_tiny_root

    from svgir_tpu_torch.train import cap_probe
    monkeypatch.setattr(cap_probe, "PROBE_CAP", 1 << 15)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield make_tiny_root(tmp_path / "root")
    torch.set_num_threads(n)
