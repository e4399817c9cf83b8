"""Deterministic chaos engineering for the orchestration layer.

The port's copy of batch_shipyard_tpu/chaos: a seeded, reproducible
fault schedule (plan.ChaosPlan — same seed, same injection sequence, the
reference's byte for byte), injectors threaded through the framework's
existing seams (injectors — store op delay/error/outage wrappers,
heartbeat blackout, task SIGKILL mid-run, SIGSTOP wedge, node preemption
on the fakepod substrate), scenario runners that drive a real fakepod
pool through the schedule and assert the self-healing invariants
(drill), and the serving fleet's drills on the port's engines
(serving_drill, on the card unless asked for the CPU).

Surfaces: `shipyard-tpu-torch chaos plan|drill` (cli). Importing this
package loads no torch.
"""

from batch_shipyard_tpu_torch.chaos.plan import (  # noqa: F401
    ChaosPlan, Injection, INJECTION_KINDS)
from batch_shipyard_tpu_torch.chaos.injectors import (  # noqa: F401
    ChaosStore)
from batch_shipyard_tpu_torch.chaos.drill import run_drill  # noqa: F401
