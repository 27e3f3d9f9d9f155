"""The harness's tests run from the root of a checkout; the port is
imported from its ``src``."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


import pytest  # noqa: E402


@pytest.fixture
def tiny_cell():
    """tiny_cell(name) -> the tiny cell, on the CPU."""
    from portbench_tiny import tiny_cell as make

    return make
