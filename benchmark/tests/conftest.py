"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
root of the checkout.  Tests marked ``card`` need a CUDA card; they decide
inside the test and skip on the CPU."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
