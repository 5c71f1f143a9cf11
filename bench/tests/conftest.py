"""The benchmark's own tests, on the CPU: ``python -m pytest bench/tests``
from the root of the repository.  Tests marked ``card`` need a CUDA device
and skip without one (decided inside the ``card`` fixture)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tests' sizes: every width cut so that a CPU run takes seconds
SMALL = {
    "sage-flickr.feature-refresh": {"n_vertices": 600, "n_edges": 6000,
                                    "f_in": 120, "hidden": 32},
    "gcn-nell.feature-refresh": {"n_vertices": 700, "n_edges": 3000,
                                 "f_in": 900, "feature_density": 0.01,
                                 "hidden": 32, "n_classes": 20},
    "gcn-nell.model-refresh": {"n_vertices": 700, "n_edges": 3000,
                               "f_in": 900, "feature_density": 0.01,
                               "hidden": 32, "n_classes": 20},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
