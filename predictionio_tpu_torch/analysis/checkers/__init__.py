"""The shipped `pio check` rules.

PIO001-PIO009 encode the fleet's safety invariants (compile ledger,
commit discipline, trace plane, lock hygiene, kill points, knob
precedence, trace-time determinism, wire determinism, telemetry
segments). PIO100-PIO102 are the reference's three ad-hoc static tests
folded into the framework. The list and its order are the reference's.
"""

from predictionio_tpu_torch.analysis.checkers.compile_ledger import (
    BareJit, TracedNondeterminism,
)
from predictionio_tpu_torch.analysis.checkers.durable_writes import (
    UncommittedDurableWrite,
)
from predictionio_tpu_torch.analysis.checkers.exceptions import (
    SwallowedKillPoint,
)
from predictionio_tpu_torch.analysis.checkers.knobs import UnregisteredKnobRead
from predictionio_tpu_torch.analysis.checkers.legacy import (
    EngineRowFind, MetricDocsDrift, StrayPrint,
)
from predictionio_tpu_torch.analysis.checkers.locks import BlockingUnderLock
from predictionio_tpu_torch.analysis.checkers.telemetry import (
    UncommittedSegmentWrite,
)
from predictionio_tpu_torch.analysis.checkers.threads import UncarriedThreadHop
from predictionio_tpu_torch.analysis.checkers.wire import WireNondeterminism

ALL_CHECKERS = [
    BareJit,                    # PIO001
    UncommittedDurableWrite,    # PIO002
    UncarriedThreadHop,         # PIO003
    BlockingUnderLock,          # PIO004
    SwallowedKillPoint,         # PIO005
    UnregisteredKnobRead,       # PIO006
    TracedNondeterminism,       # PIO007
    WireNondeterminism,         # PIO008
    UncommittedSegmentWrite,    # PIO009
    StrayPrint,                 # PIO100
    MetricDocsDrift,            # PIO101
    EngineRowFind,              # PIO102
]
