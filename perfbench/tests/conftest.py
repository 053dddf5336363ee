"""The harness's tests run on the CPU from the checkout: its root and
``src`` go on the path; tests marked ``cuda`` skip where no card is."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    # the serving stand-ins run for a fixed wall time: few threads each
    # keep parallel workers from starving one another of the CPU
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
