"""Project tables the checkers reason against, naming the port's own
modules (``predictionio_tpu_torch/...``).

Everything here is *derived from the modules that define the
discipline* rather than restated by hand where possible: the knob table
auto-registers every ``PIO_*`` literal in ``utils/server_config.py``
(the env > engine.json > server.json precedence lives there), and the
explicit entries below cover only the plumbing knobs that legitimately
bypass it (process wiring, chaos injection, kill switches) — each with
the module(s) allowed to read it. PIO006 flags any other read, which
makes adding a knob a two-line change *here* instead of a convention.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Optional, Tuple

from predictionio_tpu_torch.analysis.model import Project

KNOB_RE = re.compile(r"^PIO_[A-Z0-9_]+$")

SERVER_CONFIG_PATH = "predictionio_tpu_torch/utils/server_config.py"

#: knobs read OUTSIDE utils/server_config.py, with their owner modules.
#: An env read of a PIO_* name anywhere else is a PIO006 finding: either
#: route it through ServerConfig or register (and justify) it here.
KNOB_OWNERS: Dict[str, Tuple[str, ...]] = {
    # process/fleet wiring — consumed before any config file exists
    "PIO_NUM_PROCESSES": ("predictionio_tpu_torch/parallel/distributed.py",
                          "predictionio_tpu_torch/obs/trace_context.py"),
    "PIO_PROCESS_ID": ("predictionio_tpu_torch/parallel/distributed.py",
                       "predictionio_tpu_torch/obs/trace_context.py"),
    "PIO_COORDINATOR_ADDRESS": ("predictionio_tpu_torch/parallel/distributed.py",),
    "PIO_TRACE_CONTEXT": ("predictionio_tpu_torch/obs/trace_context.py",),
    "PIO_HOME": ("predictionio_tpu_torch/utils/config.py",
                 "predictionio_tpu_torch/storage/registry.py"),
    # observability kill switches — read on import/request paths that
    # must work even when config loading is what broke
    "PIO_TRACING": ("predictionio_tpu_torch/obs/tracing.py",),
    "PIO_ANATOMY": ("predictionio_tpu_torch/obs/anatomy.py",),
    "PIO_SLO": ("predictionio_tpu_torch/obs/slo.py",),
    "PIO_DISPATCH_ATTRIBUTION": ("predictionio_tpu_torch/obs/profiler.py",),
    "PIO_SLOW_REQUEST_SECONDS": ("predictionio_tpu_torch/obs/middleware.py",),
    "PIO_TRACE_CAPACITY": ("predictionio_tpu_torch/obs/trace_context.py",),
    "PIO_TRACE_EVENT_CAPACITY": ("predictionio_tpu_torch/obs/trace_context.py",),
    # chaos injection — deliberately env-only so a chaos run can never
    # be committed into a config file
    "PIO_FAULT_KILL": ("predictionio_tpu_torch/storage/faults.py",),
    "PIO_FAULT_OPS": ("predictionio_tpu_torch/storage/faults.py",),
    "PIO_FAULT_SEED": ("predictionio_tpu_torch/storage/faults.py",),
    "PIO_FAULT_ERROR_RATE": ("predictionio_tpu_torch/storage/faults.py",),
    "PIO_FAULT_LATENCY_S": ("predictionio_tpu_torch/storage/faults.py",),
    "PIO_FAULT_FAIL_N": ("predictionio_tpu_torch/storage/faults.py",),
    "PIO_FAULT_WHEN": ("predictionio_tpu_torch/storage/faults.py",),
    # module-local performance/debug toggles, registered with owners
    "PIO_EVLOG_CODEC": ("predictionio_tpu_torch/native/evlog.py",),
    "PIO_EVAL_VECTORIZE": ("predictionio_tpu_torch/core/evaluation.py",),
    "PIO_EVAL_BATCH_MAX": ("predictionio_tpu_torch/models/als_sweep.py",),
    "PIO_EVAL_CHUNK_MB": ("predictionio_tpu_torch/models/als_sweep.py",),
    "PIO_ENTITY_CACHE_TTL_S": ("predictionio_tpu_torch/engines/common.py",),
    "PIO_TPU_SOLVE": ("predictionio_tpu_torch/ops/linalg.py",),
    "PIO_INGEST_CACHE": ("predictionio_tpu_torch/data/ingest.py",),
    # partition count must bind identically for the server (lane count,
    # via IngestConfig) AND for offline CLI tools that open the store
    # with no server config — so the storage registry reads it directly;
    # the committed partition map on disk stays authoritative
    "PIO_INGEST_PARTITIONS": ("predictionio_tpu_torch/storage/registry.py",),
    # read only by the test suite (documented, so registered)
    "PIO_TEST_POSTGRES_URL": ("tests/",),
    # continuous-training orchestrator knob chain (env > engine.json
    # "orchestrator" > server.json) — resolved by OrchestratorConfig in
    # server_config like every other section; registered here explicitly
    # so the orchestrator's knob surface is enumerable by rule tooling
    "PIO_ORCH_INTERVAL_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_COOLDOWN_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_MIN_INGEST_EVENTS": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_FOLDIN_PENDING_MAX": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_SLO_TRIGGER": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_PHASE_TIMEOUT_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_PHASE_RETRIES": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_PHASE_BACKOFF_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_PHASE_BACKOFF_CAP_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_CYCLE_BACKOFF_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_CYCLE_BACKOFF_CAP_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_MIN_EVAL_SCORE": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_CANARY_HOLD_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_CANARY_VERDICT_TIMEOUT_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_HISTORY_WINDOW_S": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_SMOKE_QUERIES": (SERVER_CONFIG_PATH,),
    "PIO_ORCH_STATE_DIR": (SERVER_CONFIG_PATH,),
    # serving-fleet router knob chain (env > server.json "router") —
    # resolved by RouterConfig in server_config; registered explicitly
    # so the router's knob surface is enumerable by rule tooling
    "PIO_ROUTER_PORT": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_REPLICAS": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_BASE_PORT": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_HEALTH_INTERVAL_S": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_HEALTH_FAIL_AFTER": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_PROXY_RETRIES": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_DRAIN_TIMEOUT_S": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_HEALTH_BACKOFF_CAP_S": (SERVER_CONFIG_PATH,),
    "PIO_ROUTER_PERSIST_SPLITTER": (SERVER_CONFIG_PATH,),
    # SLO-driven autoscaler knob chain (env > server.json "fleet") —
    # resolved by FleetConfig in server_config
    "PIO_FLEET_AUTOSCALE": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_MIN_REPLICAS": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_MAX_REPLICAS": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_BURN_SUSTAIN_S": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_IDLE_QPS": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_IDLE_SUSTAIN_S": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_COOLDOWN_S": (SERVER_CONFIG_PATH,),
    "PIO_FLEET_STATE_DIR": (SERVER_CONFIG_PATH,),
    # workload-simulator knob chain (env > server.json "loadtest") —
    # resolved by LoadtestConfig in server_config; scales a scenario
    # file (population / duration / rate) without editing it
    "PIO_LOADTEST_POPULATION": (SERVER_CONFIG_PATH,),
    "PIO_LOADTEST_DURATION_S": (SERVER_CONFIG_PATH,),
    "PIO_LOADTEST_RATE_SCALE": (SERVER_CONFIG_PATH,),
    "PIO_LOADTEST_SEED": (SERVER_CONFIG_PATH,),
    "PIO_LOADTEST_OUTSTANDING": (SERVER_CONFIG_PATH,),
    "PIO_LOADTEST_REPORT_DIR": (SERVER_CONFIG_PATH,),
    # multi-tenant host knob chain (env > server.json "multitenant") —
    # resolved by MultiTenantConfig in server_config; the residency
    # budget, warm-reload wait, LRU sweep, and admission gate
    "PIO_MT_DEVICE_BUDGET_BYTES": (SERVER_CONFIG_PATH,),
    "PIO_MT_RELOAD_WAIT_S": (SERVER_CONFIG_PATH,),
    "PIO_MT_SWEEP_INTERVAL_S": (SERVER_CONFIG_PATH,),
    "PIO_MT_MIN_RESIDENT": (SERVER_CONFIG_PATH,),
    "PIO_MT_ADMISSION": (SERVER_CONFIG_PATH,),
    "PIO_MT_RETRY_AFTER_S": (SERVER_CONFIG_PATH,),
    "PIO_MT_MAX_TENANT_SERIES": (SERVER_CONFIG_PATH,),
}

#: knobs the reference reads in a module the port does not have yet,
#: with the reason. They are documented (README.md), nothing in the port
#: reads them, and the docs-drift gates count them as known.
KNOBS_NOT_PORTED: Dict[str, str] = {
    "PIO_VIEW_CACHE_DIR": "owned by the reference's data/view.py, which "
                          "needs pyarrow (ROADMAP Queue 1 item 8)",
}

#: knob *families* read via pattern scan (no literal name per knob) —
#: matched by prefix in the knob-docs gate and by PIO006
KNOB_PREFIXES: Dict[str, Tuple[str, ...]] = {
    "PIO_STORAGE_SOURCES_": ("predictionio_tpu_torch/storage/registry.py",),
    "PIO_STORAGE_REPOSITORIES_": ("predictionio_tpu_torch/storage/registry.py",),
    "PIO_FAULT_": ("predictionio_tpu_torch/storage/faults.py",),
}


def server_config_knobs(project: Project) -> Tuple[str, ...]:
    """Every PIO_* string literal in utils/server_config.py — those
    knobs are owned by the config precedence chain itself."""
    f = project.file(SERVER_CONFIG_PATH)
    if f is None:
        return ()
    names = set()
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and KNOB_RE.match(node.value):
            names.add(node.value)
    return tuple(sorted(names))


def knob_table(project: Project) -> Dict[str, Tuple[str, ...]]:
    """knob name -> module paths allowed to read it directly."""
    table = dict(KNOB_OWNERS)
    for name in server_config_knobs(project):
        table.setdefault(name, ())
        table[name] = tuple(dict.fromkeys(
            table[name] + (SERVER_CONFIG_PATH,)))
    return table


def owner_for(table: Dict[str, Tuple[str, ...]], knob: str
              ) -> Optional[Tuple[str, ...]]:
    """Owners of a knob, resolving prefix families; None = unregistered."""
    if knob in table:
        return table[knob]
    for prefix, owners in KNOB_PREFIXES.items():
        if knob.startswith(prefix):
            return owners
    return None


# -- PIO002: the temp-write + rename commit discipline -----------------------

#: dotted call paths that COMMIT a durable file (the rename side)
COMMIT_DOTTED = frozenset({"os.replace", "os.rename"})
#: method names that commit on a filesystem object (fs.mv(tmp, path))
COMMIT_ATTRS = frozenset({"mv"})

# -- PIO009: telemetry segment writers ---------------------------------------

#: module -> function names allowed to open segment files for writing.
#: The durable-telemetry store (obs/tsdb.py) is append-only WITHOUT the
#: temp-write+rename commit on its hot path — its crash safety rests on
#: checksummed length-prefixed records plus torn-tail truncation, which
#: only holds if every byte flows through the helpers that implement
#: that discipline: `_append_payload` (checksummed append, chaos kill
#: point inside), `_commit_file` (the temp-write+rename rewrite for
#: segment roll/compaction), and `_ensure_active` (creates the empty
#: active file the append helper owns). Any other write in these
#: modules is a PIO009 finding: route it through the helpers or
#: register (and justify) it here.
SEGMENT_WRITE_HELPERS: Dict[str, Tuple[str, ...]] = {
    "predictionio_tpu_torch/obs/tsdb.py": (
        "_append_payload", "_commit_file", "_ensure_active"),
    "predictionio_tpu_torch/obs/telemetry.py": (),
    # the shared log-structured substrate: the committed-rewrite
    # and staged-commit primitives both segment disciplines ride — every
    # write here performs its own rename commit
    "predictionio_tpu_torch/storage/logstore.py": (
        "commit_file", "fs_commit_stream", "fs_commit_bytes"),
}
# (_claim_dir commits the WRITER pid file THROUGH _commit_file, so it
# needs no entry of its own; tsdb._commit_file delegates to
# logstore.commit_file and keeps its registered name for the discipline)

# -- PIO003: trace-plane carriers --------------------------------------------

#: calling any of these means the hop participates in the trace plane
TRACE_CARRIERS = frozenset({"carried", "capture_context", "adopt"})
#: executor receivers whose .submit(fn, ...) is a thread hop
EXECUTOR_NAME_RE = re.compile(r"(executor|pool)", re.IGNORECASE)

# -- PIO004: no blocking work under a held lock ------------------------------

LOCK_NAME_RE = re.compile(r"lock", re.IGNORECASE)
#: paths where lock bodies are latency-critical (swap/serving/metrics)
LOCK_SCOPE_PREFIXES = ("predictionio_tpu_torch/deploy/", "predictionio_tpu_torch/obs/")
LOCK_SCOPE_FILES = ("predictionio_tpu_torch/data/write_buffer.py",
                    "predictionio_tpu_torch/server/query_server.py")
#: dotted paths / method names that block
BLOCKING_DOTTED = frozenset({
    "time.sleep", "os.replace", "os.rename", "os.fsync",
    "urllib.request.urlopen", "subprocess.run", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "requests.get", "requests.post", "requests.request",
    "socket.create_connection",
})
BLOCKING_ATTRS = frozenset({"result"})      # concurrent.futures waits
BLOCKING_BUILTINS = frozenset({"open"})

# -- PIO007: nondeterminism inside traced/jitted functions -------------------

NONDET_DOTTED = frozenset({
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "uuid.uuid4", "uuid.uuid1",
})
NONDET_MODULE_PREFIXES = ("random.", "np.random.", "numpy.random.")

# -- PIO008: serialized wire paths -------------------------------------------

WIRE_MODULES = (
    "predictionio_tpu_torch/data/event.py",
    "predictionio_tpu_torch/data/columnar.py",
    "predictionio_tpu_torch/workflow/serialization.py",
    "predictionio_tpu_torch/obs/fleet.py",
)

# -- scopes ------------------------------------------------------------------

#: the compile-ledger module itself is exempt from PIO001 (the port has
#: none: nothing compiles at trace time; the path keeps the reference's
#: fixtures meaning the same)
FN_CACHE_PATH = "predictionio_tpu_torch/ops/fn_cache.py"
#: builder-registering entry points of the compile ledger
FN_CACHE_BUILDERS = {"mesh_cached_fn": 3, "shape_cached_fn": 2}

ENGINES_PREFIX = "predictionio_tpu_torch/engines/"
PKG_PREFIX = "predictionio_tpu_torch/"
