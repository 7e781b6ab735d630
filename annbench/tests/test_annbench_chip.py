"""On a card: each cell's whole run at a tiny size, the comparison passing
the program and failing the control."""

import pytest

from annbench import spec
from annbench.control import ReferenceSystem
from annbench.testing import run_small

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    out = run_small(name, device=card, trace=True, seconds=2.0)
    assert out.correct, out.checks
    assert out.slice is not None and out.slice.busy_s > 0
    control = run_small(name, device=card, system_factory=ReferenceSystem)
    assert not control.correct
