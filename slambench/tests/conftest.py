"""The benchmark's own tests: ``python -m pytest slambench/tests`` from the
checkout's root. Tests marked ``card`` need a CUDA card and skip without
one (they decide inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; run on the "
                            "card with python -m pytest slambench/tests -m "
                            "card")
