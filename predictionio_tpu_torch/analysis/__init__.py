"""Project static analysis: the fleet's safety invariants, machine-checked
(the port's copy of the reference's ``analysis`` package, pointed at the
port's own tree).

The conventions the serving fleet rests on — every durable write is
temp-write + rename, every thread hop carries the trace plane, no
blocking I/O under a swap lock, kill points stay lethal — are rules of a
checker engine (``python -m predictionio_tpu_torch.cli.main check``):

* :mod:`predictionio_tpu_torch.analysis.model` — parsed sources, suppression
  comments (``# pio: ignore[RULE]: reason``), virtual projects for tests;
* :mod:`predictionio_tpu_torch.analysis.callgraph` — the cross-module
  function/call index whole-program passes reason over;
* :mod:`predictionio_tpu_torch.analysis.registry` — the knob/committer/lock
  tables derived from the modules that define those disciplines;
* :mod:`predictionio_tpu_torch.analysis.engine` — the checker SPI, baseline
  semantics, JSON/human reports;
* :mod:`predictionio_tpu_torch.analysis.checkers` — the shipped rules
  (PIO001-PIO009 project invariants, PIO100-PIO102 the legacy gates).

The rule set, the matching logic and the report are the reference's;
only the paths differ: :meth:`Project.from_root` scans
``predictionio_tpu_torch/`` plus ``chip_smoke.py``, the registry names
the port's modules, and the default baseline is
``conf/pio_check_baseline_torch.json``. PIO001 and PIO007 match
``jax.jit``/``jax.pmap`` builders and values frozen at trace time; the
port compiles nothing at trace time, so on its tree they find nothing.
"""

from predictionio_tpu_torch.analysis.engine import (   # noqa: F401
    Baseline, Checker, Finding, Report, all_rules, run_check,
)
from predictionio_tpu_torch.analysis.model import Project, SourceFile  # noqa: F401
