"""Settings of the benchmark's own tests: the repository root on the
path, one torch thread per worker, and the ``card`` marker of tests that
need a CUDA device (they decide inside the test and skip without one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
    import torch

    torch.set_num_threads(1)
