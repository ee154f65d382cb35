"""Scenario fuzzer: adversarial storms and machine-checked SWIM invariants.

Counterpart of ``ringpop_tpu/fuzz/``: :mod:`.scenarios` (seeded storm
schedules over both engines' fault primitives), :mod:`.executor` (B
instances stepped together under ``torch.func.vmap``, their flight-recorder
streams drained), :mod:`.invariants` (the protocol invariants over streams,
states and metrics), :mod:`.shrinker` (a failing seed bisected to a
minimal fixture) and :mod:`.crash` (a driver killed at a seed-drawn tick,
mid-checkpoint-write included, restored from its newest valid checkpoint
and held bitwise to its uninterrupted twin).
"""

from ringpop_tpu_torch.fuzz.scenarios import (  # noqa: F401
    CrashPlan,
    ScenarioConfig,
    crash_plan_of,
    generate,
    packet_loss_of,
    schedule_from_faults,
    sparse_faults,
)
from ringpop_tpu_torch.fuzz.executor import (  # noqa: F401
    FullFuzzExecutor,
    FuzzRun,
    ScalableFuzzExecutor,
    executor_for,
    sweep,
)
from ringpop_tpu_torch.fuzz.invariants import (  # noqa: F401
    Violation,
    check_run,
)
from ringpop_tpu_torch.fuzz.crash import (  # noqa: F401
    DRIVERS,
    RESUME_BITWISE,
    ROUTED,
    CrashReport,
    build_driver,
    corrupt_checkpoint,
    run_crash_resume,
    sweep_crash,
)
from ringpop_tpu_torch.fuzz.shrinker import (  # noqa: F401
    ShrinkResult,
    load_fixture,
    replay_fixture,
    save_fixture,
    shrink,
    shrink_seed,
)
