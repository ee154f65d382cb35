"""With the timed path broken underneath, ``correct`` comes out false.

One run per fault the cell can have (a cell on one chip has no exchange
between chips): a step that returns its state unchanged; half of the
batch left out (the ensemble); an answer altered where it is produced (a
checksum in the full engine's tick, a reception word out of ``exchange``).
Each fault fails a number that shares no code with the program, not only
the frozen twin's (``start_mismatch``, ``window_mismatch``).
"""

import pytest

from portbench.tests.conftest import TINY_SIM, TINY_STORM, run_cell

TWIN = ("start_mismatch", "window_mismatch")


def _independent_failures(result):
    return {k: v["value"] for k, v in result["compared"].items()
            if k not in TWIN and v["value"] > v["limit"]}

ENSEMBLE_FAULTS = {
    "state_unchanged": """
        from ringpop_tpu_torch.models.sim import batched
        _orig = batched.BatchedSimClusters._tick
        batched.BatchedSimClusters._tick = lambda self, s, i: (s, _orig(self, s, i)[1])
    """,
    "half_the_batch_left_out": """
        import torch
        from ringpop_tpu_torch.models.sim import batched
        _orig = batched.BatchedSimClusters._tick
        def _half(self, s, i):
            new, m = _orig(self, s, i)
            h = self.b // 2
            return type(s)(*(None if a is None or a.dim() == 0 else torch.cat([a[:h], b[h:]])
                             for a, b in zip(new, s))), m
        batched.BatchedSimClusters._tick = _half
    """,
    "checksum_altered": """
        import torch
        from ringpop_tpu_torch.models.sim import engine
        _orig = engine.tick
        def _flip(state, inputs, params, universe):
            new, m = _orig(state, inputs, params, universe)
            node0 = (torch.arange(new.checksum.shape[-1], device=new.checksum.device) == 0).int()
            return new._replace(checksum=new.checksum ^ node0), m
        engine.tick = _flip
    """,
}

STORM_FAULTS = {
    "state_unchanged": """
        from ringpop_tpu_torch.models.sim import engine_scalable as es
        _orig = es.tick
        es.tick = lambda s, i, p, *a, **k: (s, _orig(s, i, p, *a, **k)[1])
    """,
    "exchange_word_altered": """
        from ringpop_tpu_torch.ops import exchange as ex
        def _altered(fn):
            def run(*a, **k):
                new, acc, cnt = fn(*a, **k)
                # every word loses its lowest heard bit
                return new & (new - 1), acc, cnt
            # the wrapper counts its launches on the function object
            run.launches = getattr(fn, "launches", 0)
            return run
        # the kernel's entry on the card, its plain version on the CPU
        ex.exchange = _altered(ex.exchange)
        ex.exchange_plain = _altered(ex.exchange_plain)
    """,
}


@pytest.mark.parametrize("fault", sorted(ENSEMBLE_FAULTS))
def test_ensemble_fault_is_not_correct(tiny_checkout, fault):
    code, result, err = run_cell(tiny_checkout, TINY_SIM, 11, before=ENSEMBLE_FAULTS[fault])
    assert code == 0, err[-2000:]
    assert result["correct"] is False, result["compared"]
    assert _independent_failures(result), result["compared"]


@pytest.mark.parametrize("fault", sorted(STORM_FAULTS))
def test_storm_fault_is_not_correct(tiny_checkout, fault):
    code, result, err = run_cell(tiny_checkout, TINY_STORM, 12, before=STORM_FAULTS[fault])
    assert code == 0, err[-2000:]
    assert result["correct"] is False, result["compared"]
    assert _independent_failures(result), result["compared"]
