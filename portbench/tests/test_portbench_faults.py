"""A run with the timed path broken underneath comes out not correct:
once for each fault a serving cell can have (on one chip there is no
exchange between chips to leave out). The runs skip the harness's look
for a chip and run the smoke configurations on the CPU."""
import pytest

from portbench.tests._faults import half_the_batch, state_unchanged, token_altered
from portbench.tests._smoke import CELLS, run_smoke


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, smoke_root):
    assert run_smoke(cell, smoke_root)["correct"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, token_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_not_correct(cell, fault, monkeypatch, smoke_root):
    fault(monkeypatch)
    r = run_smoke(cell, smoke_root)
    assert not r["correct"], r["checks"]
