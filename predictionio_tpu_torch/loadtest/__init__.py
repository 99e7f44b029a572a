"""`pio loadtest`: the whole-fleet workload simulator (port of the
reference's ``loadtest`` package).

Every number the repo produced before this package came from bench
configs exercising ONE subsystem at a time (ingest alone, serving
alone, scoring alone). This package drives them *concurrently*: a
synthetic user population (population.py — Zipfian item popularity,
diurnal arrival curves, lazy per-user session state) emits mixed
traffic — events to the event server, queries through the router,
feedback closing the fold-in loop — in open-loop mode with the ingest
bench's latency-accounting discipline (harness.py), against an
in-process fleet (fleet.py) whose incidents a declarative scenario
file injects (scenario.py), while a runtime invariant engine
(invariants.py) turns the `pio check`-era guarantees into live
assertions: no dropped acks, exactly-once ingest (storage/audit.py),
the release registry converging to one LIVE, freshness holding while
the orchestrator retrains mid-storm.
"""

from predictionio_tpu_torch.loadtest.harness import (  # noqa: F401
    LatencyLedger, OpenLoopResult, drive_open_loop,
)
from predictionio_tpu_torch.loadtest.population import (  # noqa: F401
    Population, ZipfSampler, arrival_offsets, diurnal_rate,
)
from predictionio_tpu_torch.loadtest.scenario import (  # noqa: F401
    Incident, Scenario, ScenarioError, TenantMix,
)
