"""Settings of the benchmark's own tests: the `chip` marker, and a tiny
size at which a whole run of a cell fits on the CPU."""

import pytest
import torch

# the sizes of tests/test_e2e_torch_parity.py: B = 2, 16^3, channels
# (4, 8, 16), 4 experts; float32, where the program on the CPU and the
# reference agree to rounding
TINY = {"model": {"channels": [4, 8, 16], "strides": [2, 2, 2],
                  "latent_spaces": [32, 32, 32], "num_experts": 4},
        "traffic": {"volume": 16, "rois": 5, "trace_units": 2,
                    "compute_dtype": "float32"}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
