"""The control, the reference in a lower precision in the program's
place, comes out incorrect on every seed; the program, on the same seeds,
correct (the CPU at a tiny size; on the card at the cells' own size the
same readings come from benchmark/control.py)."""
import pytest

from helpers import small_cell
from benchmark import check, control


@pytest.mark.parametrize("cell", ["facade_p25.exact", "clutter_p25.exact",
                                  "facade_p25.noisy"])
def test_the_control_fails_and_the_program_passes(cell):
    spec = small_cell(cell)
    limits = spec["workload"]["check"]["limits"]
    for seed in (5, 2 ** 31 + 3, 1234567):
        sound, ctrl = control.readings(spec, seed, "cpu")
        assert check.judge(sound, limits)[0], sound
        assert not check.judge(ctrl, limits)[0], ctrl
