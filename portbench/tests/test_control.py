"""The control: the reference in the program's place with one stated
guarantee broken comes out not correct, on the number that guards it.

The full engine's control hashes with the fast commutative checksum in
place of FarmHash32 of the Node checksum string; the storm's keeps no
checksum in the tick (``checksum_in_tick=False``).  On the card the same
runs are ``run.py --control`` at the cells' own sizes.
"""

import pytest

from portbench.tests.conftest import TINY_SIM, TINY_STORM, run_cell


@pytest.mark.parametrize("seed", [21, 2**31 + 5])
def test_ensemble_control_fails_the_checksum_number(tiny_checkout, seed):
    code, result, err = run_cell(tiny_checkout, TINY_SIM, seed, "--control")
    assert code == 0, err[-2000:]
    assert result["correct"] is False
    compared = result["compared"]
    assert compared["checksum_mismatch"]["value"] > 0
    # the transitions themselves are the reference's
    for name in ("start_mismatch", "window_mismatch", "precedence_violations",
                 "suspicion_violations", "plan_mismatch"):
        assert compared[name]["value"] == 0, name


@pytest.mark.parametrize("seed", [22, 2**31 + 6])
def test_storm_control_fails(tiny_checkout, seed):
    code, result, err = run_cell(tiny_checkout, TINY_STORM, seed, "--control")
    assert code == 0, err[-2000:]
    assert result["correct"] is False
    assert result["compared"]["window_mismatch"]["value"] > 0
    # every node's checksum, recomputed from the state, disagrees with one
    # the tick did not keep
    assert result["compared"]["checksum_mismatch"]["value"] > 0
