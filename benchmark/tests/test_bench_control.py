"""On the card, at the cell's own size and load: the program's runs are
correct and the control (the reference in the nearest precision below
the configuration's, in the program's place) is not, on three seeds.
Short windows: one encode."""

import pytest

from benchmark import control

SECONDS = {"ai_faster_d416.file": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_control_fails_where_the_program_passes(card, cell):
    rows = list(control.readings(cell, [70001, 2 ** 31 + 70002, 70003],
                                 SECONDS[cell]))
    for r in rows:
        assert r["correct"], r
        assert not r["control_correct"], r
