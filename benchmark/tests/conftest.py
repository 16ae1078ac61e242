"""The benchmark's own tests (python -m pytest benchmark/tests from the root
of the repository).  Tests that need the card carry the ``cuda`` marker and
skip inside the test where there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the benchmark's cells run on "
        "the card)")
