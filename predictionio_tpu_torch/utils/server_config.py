"""Server security, serving, scorer, ingest, training-solver, fold-in,
deploy, batch-predict, telemetry, orchestrator, router, fleet and
multi-tenant knobs: the ``key``, ``ssl``, ``serving``, ``scorer``,
``ingest``, ``train``, ``foldin``, ``deploy``, ``batchpredict``,
``telemetry``, ``orchestrator``, ``router``, ``fleet`` and
``multitenant`` sections of the reference's ``utils/server_config.py``
(``ServerConfig`` with ``check_key`` and ``ssl_context``,
``ServingConfig``, ``ScorerConfig``,
``scorer_config``, ``IngestConfig``, ``TrainConfig``,
``als_solver_config``, ``FoldinConfig``, ``foldin_config``,
``DeployConfig``, ``deploy_config``, ``BatchPredictConfig``,
``batchpredict_config``, ``TelemetryConfig``, ``OrchestratorConfig``,
``orchestrator_config``, ``RouterConfig``, ``router_config``,
``FleetConfig``, ``fleet_config``, ``MultiTenantConfig``,
``multitenant_config``), with their precedence unchanged —
server.json section < engine.json (the top-level ``scorer``, ``foldin``
and ``batchpredict`` sections, the algorithm's ``solver`` params) <
``PIO_SCORER_*`` / ``PIO_INGEST_*`` / ``PIO_ALS_*`` / ``PIO_FOLDIN*`` /
``PIO_DEPLOY_*`` / ``PIO_CANARY_*`` / ``PIO_BATCHPREDICT_*`` /
``PIO_TELEMETRY*`` / ``PIO_ORCH_*`` environment (the ``router``,
``fleet`` and ``multitenant`` sections have no engine.json level:
server.json < ``PIO_ROUTER_*`` / ``PIO_FLEET_*`` / ``PIO_MT_*``; nor do
``key``, ``ssl`` and ``serving``: server.json < ``PIO_SERVER_KEY`` /
``PIO_SSL_CERTFILE`` (which turns TLS on) / ``PIO_SSL_KEYFILE`` /
``PIO_BATCH_*``).

The server.json path is resolved as the reference resolves it:
``PIO_SERVER_CONF``, else ``$PIO_CONF_DIR/server.json``, else
``$PIO_HOME/conf/server.json``.
"""

from __future__ import annotations

import dataclasses
import hmac
import json
import logging
import os
import ssl
from typing import Optional

from predictionio_tpu_torch.utils.config import pio_home

logger = logging.getLogger("pio.torch.config")

SCORER_MODES = ("exact", "fused", "fused_bf16", "fused_int8", "twostage")


def read_server_json(path: Optional[str] = None) -> dict:
    """The raw server.json contents ({} when absent/unreadable)."""
    if path is None:
        conf_dir = os.environ.get(
            "PIO_CONF_DIR", os.path.join(pio_home(), "conf"))
        path = os.environ.get("PIO_SERVER_CONF",
                              os.path.join(conf_dir, "server.json"))
    if os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("cannot read server config %s: %s", path, e)
    return {}


@dataclasses.dataclass
class ServingConfig:
    """Query-server micro-batch tuning (the ``PIO_BATCH_*`` knobs).

    ``batch_linger_s = None`` is the adaptive linger: the batcher waits
    only when another batch is in flight, for about twice the arrival
    interval's EWMA (``server/query_server.MicroBatcher``). A number
    forces a fixed linger; ``0`` disables it."""

    batch_max: int = 64          # largest micro-batch
    batch_linger_s: Optional[float] = None   # None: adaptive linger
    batch_inflight: int = 2      # micro-batches running at once

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "ServingConfig":
        """``PIO_BATCH_*`` env over a server.json ``serving`` section
        (camelCase keys). A malformed value, in the file or the env, is
        logged and falls back: a bad knob never stops a server."""
        data = data or {}
        cfg = cls()
        sources = (
            ("batchMax", data.get("batchMax"), "batch_max", int),
            ("batchLingerS", data.get("batchLingerS"), "batch_linger_s",
             float),
            ("batchInflight", data.get("batchInflight"), "batch_inflight",
             int),
            ("PIO_BATCH_MAX", os.environ.get("PIO_BATCH_MAX"),
             "batch_max", int),
            ("PIO_BATCH_LINGER_S", os.environ.get("PIO_BATCH_LINGER_S"),
             "batch_linger_s", float),
            ("PIO_BATCH_INFLIGHT", os.environ.get("PIO_BATCH_INFLIGHT"),
             "batch_inflight", int),
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed serving knob %s=%r",
                               name, raw)
        cfg.batch_max = max(1, cfg.batch_max)
        cfg.batch_inflight = max(1, cfg.batch_inflight)
        return cfg


@dataclasses.dataclass
class ScorerConfig:
    """Top-k scoring-kernel selection (the ``PIO_SCORER_*`` knobs).

    ``mode`` picks the scorer every ALS model serves with: ``exact``
    (materialize [B,N] f32 + top-k), ``fused`` (tiled streaming top-k,
    f32), ``fused_bf16`` / ``fused_int8`` (the same scan over bf16 /
    per-row-scaled int8 resident factors, f32 accumulation), and
    ``twostage`` (rotated truncated int8 scan to a ``shortlist``-sized
    candidate set — the hand-written shortlist kernel — then an exact f32
    rescore of the shortlist). ``tile_items`` is the item-tile width
    (rounded up to a power of two); ``shortlist`` the two-stage candidate
    count per query. Every non-exact scorer is parity-gated at build
    against the exact path and falls back to exact below ``min_recall``
    recall@10.

    ``shards`` > 1 splits the catalog row-wise into that many shards,
    one scorer a shard, merged on the host (``ops/scoring.ShardedScorer``;
    on one card every shard shares it).
    """

    mode: str = "exact"
    tile_items: int = 16384
    shortlist: int = 512
    min_recall: float = 0.99
    shards: int = 1

    @classmethod
    def from_env(cls, data: Optional[dict] = None,
                 variant: Optional[dict] = None) -> "ScorerConfig":
        """Per-knob precedence, weakest first: server.json ``scorer``
        section (``data``) < engine.json ``scorer`` section
        (``variant``) < ``PIO_SCORER_*`` env. Malformed knobs are
        logged and fall back."""
        data = data or {}
        variant = variant or {}
        cfg = cls()

        def as_mode(v):
            s = str(v).strip().lower()
            if s not in SCORER_MODES:
                raise ValueError(s)
            return s

        file_keys = (
            ("mode", "mode", as_mode),
            ("tileItems", "tile_items", int),
            ("shortlist", "shortlist", int),
            ("minRecall", "min_recall", float),
            ("shards", "shards", int),
        )
        env_keys = (
            ("PIO_SCORER_MODE", "mode", as_mode),
            ("PIO_SCORER_TILE_ITEMS", "tile_items", int),
            ("PIO_SCORER_SHORTLIST", "shortlist", int),
            ("PIO_SCORER_SHARDS", "shards", int),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(f"engine.json {k}", variant.get(k), attr, conv)
               for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed scorer knob %s=%r",
                               name, raw)
        cfg.tile_items = max(128, cfg.tile_items)
        cfg.shortlist = max(16, cfg.shortlist)
        cfg.min_recall = min(1.0, max(0.0, cfg.min_recall))
        cfg.shards = max(1, cfg.shards)
        return cfg

    def cache_key(self) -> tuple:
        """What invalidates a built scorer when the config changes."""
        return (self.mode, self.tile_items, self.shortlist,
                self.min_recall, self.shards)


def scorer_config(variant_section: Optional[dict] = None) -> ScorerConfig:
    """Resolve the scoring-kernel knobs a serving process runs with:
    ``variant_section`` is the engine.json top-level ``scorer`` section,
    which overrides the host-level server.json section; the
    ``PIO_SCORER_*`` env vars override both."""
    data = read_server_json().get("scorer") or {}
    return ScorerConfig.from_env(data, variant_section)


@dataclasses.dataclass
class FoldinConfig:
    """Online fold-in tuning (server.json ``foldin`` section, camelCase
    keys; an engine.json top-level ``foldin`` section overrides the host
    file; the ``PIO_FOLDIN*`` env vars override both).

    ``enabled`` starts the query server's fold-in controller
    (``deploy/foldin``) when the deployed engine supports it.
    ``apply_interval_s`` is the apply cadence (p95 event->reflected is
    about the interval plus one apply); ``max_pending`` caps the rows one
    apply folds (the rest wait for the next tick) and, once that many
    rows wait, wakes the apply early; ``row_len`` is the packed-row width
    of the batched solve (heavy entities span several rows)."""

    enabled: bool = False
    apply_interval_s: float = 2.0
    max_pending: int = 1024
    row_len: int = 32

    @classmethod
    def from_env(cls, data: Optional[dict] = None,
                 variant: Optional[dict] = None) -> "FoldinConfig":
        """Per knob, weakest first: server.json ``foldin`` section
        (``data``) < engine.json ``foldin`` section (``variant``) <
        ``PIO_FOLDIN*`` env. Malformed knobs are logged and fall back."""
        data = data or {}
        variant = variant or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        keys = (
            ("enabled", "PIO_FOLDIN", "enabled", as_bool),
            ("applyIntervalS", "PIO_FOLDIN_APPLY_INTERVAL_S",
             "apply_interval_s", float),
            ("maxPending", "PIO_FOLDIN_MAX_PENDING", "max_pending", int),
            ("rowLen", "PIO_FOLDIN_ROW_LEN", "row_len", int),
        )
        sources = ([(k, data.get(k), attr, conv)
                    for k, _e, attr, conv in keys]
                   + [(f"engine.json {k}", variant.get(k), attr, conv)
                      for k, _e, attr, conv in keys]
                   + [(e, os.environ.get(e), attr, conv)
                      for _k, e, attr, conv in keys])
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed foldin knob %s=%r",
                               name, raw)
        cfg.apply_interval_s = max(0.01, cfg.apply_interval_s)
        cfg.max_pending = max(1, cfg.max_pending)
        cfg.row_len = max(1, cfg.row_len)
        return cfg


def foldin_config(variant_section: Optional[dict] = None) -> FoldinConfig:
    """Resolve the fold-in knobs a query server runs with:
    ``variant_section`` is the engine.json top-level ``foldin`` section,
    which overrides the host-level server.json section; the
    ``PIO_FOLDIN*`` env vars override both."""
    data = read_server_json().get("foldin") or {}
    return FoldinConfig.from_env(data, variant_section)


@dataclasses.dataclass
class DeployConfig:
    """Deploy-lifecycle tuning (server.json ``deploy`` section, camelCase
    keys; the ``PIO_DEPLOY_*`` and ``PIO_CANARY_*`` env vars win).

    ``warmup=False`` makes ``/reload`` and ``/deploy.json`` cold swaps;
    ``drain_timeout_s`` bounds the wait for a retired unit's batches.
    The ``canary_*`` fields are the defaults of a staged rollout; a
    ``POST /deploy.json`` body overrides any of them."""

    warmup: bool = True
    drain_timeout_s: float = 5.0
    canary_fraction: float = 0.1
    canary_window: int = 200
    canary_min_samples: int = 20
    canary_promote_after: int = 100
    canary_p99_ratio: float = 2.0
    canary_latency_slack_s: float = 0.025
    canary_error_rate_slack: float = 0.05

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "DeployConfig":
        """server.json ``deploy`` section overlaid by env vars (env
        wins); malformed knobs are logged and fall back."""
        data = data or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        keys = (
            ("warmup", "PIO_DEPLOY_WARMUP", "warmup", as_bool),
            ("drainTimeoutS", "PIO_DEPLOY_DRAIN_TIMEOUT_S",
             "drain_timeout_s", float),
            ("canaryFraction", "PIO_CANARY_FRACTION", "canary_fraction",
             float),
            ("canaryWindow", "PIO_CANARY_WINDOW", "canary_window", int),
            ("canaryMinSamples", "PIO_CANARY_MIN_SAMPLES",
             "canary_min_samples", int),
            ("canaryPromoteAfter", "PIO_CANARY_PROMOTE_AFTER",
             "canary_promote_after", int),
            ("canaryP99Ratio", "PIO_CANARY_P99_RATIO", "canary_p99_ratio",
             float),
            ("canaryLatencySlackS", "PIO_CANARY_LATENCY_SLACK_S",
             "canary_latency_slack_s", float),
            ("canaryErrorRateSlack", "PIO_CANARY_ERROR_SLACK",
             "canary_error_rate_slack", float),
        )
        sources = ([(k, data.get(k), attr, conv)
                    for k, _e, attr, conv in keys]
                   + [(e, os.environ.get(e), attr, conv)
                      for _k, e, attr, conv in keys])
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed deploy knob %s=%r",
                               name, raw)
        return cfg


def deploy_config() -> DeployConfig:
    """The query server's deploy knobs (server.json ``deploy`` section <
    env)."""
    return DeployConfig.from_env(read_server_json().get("deploy") or {})


@dataclasses.dataclass
class IngestConfig:
    """Event-server ingest tuning (server.json ``ingest`` section,
    camelCase keys; the ``PIO_INGEST_*`` and ``PIO_MAX_EVENTS_PER_BATCH``
    env vars win).

    ``buffer=True`` routes event writes through the group-commit
    ``WriteBuffer`` (``data/write_buffer``): a queue bounded at
    ``queue_max`` events (past it the server answers 429 with
    Retry-After), flushes of up to ``flush_max`` events after at most
    ``linger_s``, ``retries`` retries with backoff from ``backoff_s``
    (capped at ``backoff_cap_s``) and ``flush_timeout_s`` per storage
    call. ``buffer=False`` writes per request. ``max_events_per_batch``
    caps ``/batch/events.json`` (EventServer.scala:66). ``partitions``
    runs the buffer as that many parallel commit lanes, one per partition
    of the event store (``storage/partitioned``); set
    ``PIO_INGEST_PARTITIONS`` alike for the server and the offline
    commands so the store's layout agrees (a committed partition map on
    disk stays authoritative; a count change takes ``pio reshard``)."""

    max_events_per_batch: int = 50
    buffer: bool = True
    queue_max: int = 8192
    flush_max: int = 256
    linger_s: float = 0.002
    retries: int = 4
    backoff_s: float = 0.05
    backoff_cap_s: float = 1.0
    flush_timeout_s: float = 30.0
    partitions: int = 1

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "IngestConfig":
        """server.json ``ingest`` section overlaid by env vars (env
        wins); malformed knobs are logged and fall back."""
        data = data or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        keys = (
            ("maxEventsPerBatch", "PIO_MAX_EVENTS_PER_BATCH",
             "max_events_per_batch", int),
            ("buffer", "PIO_INGEST_BUFFER", "buffer", as_bool),
            ("queueMax", "PIO_INGEST_QUEUE_MAX", "queue_max", int),
            ("flushMax", "PIO_INGEST_FLUSH_MAX", "flush_max", int),
            ("lingerS", "PIO_INGEST_LINGER_S", "linger_s", float),
            ("retries", "PIO_INGEST_RETRIES", "retries", int),
            ("backoffS", "PIO_INGEST_BACKOFF_S", "backoff_s", float),
            ("backoffCapS", "PIO_INGEST_BACKOFF_CAP_S", "backoff_cap_s",
             float),
            ("flushTimeoutS", "PIO_INGEST_FLUSH_TIMEOUT_S",
             "flush_timeout_s", float),
            ("partitions", "PIO_INGEST_PARTITIONS", "partitions", int),
        )
        sources = ([(k, data.get(k), attr, conv)
                    for k, _e, attr, conv in keys]
                   + [(e, os.environ.get(e), attr, conv)
                      for _k, e, attr, conv in keys])
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed ingest knob %s=%r",
                               name, raw)
        cfg.max_events_per_batch = max(1, cfg.max_events_per_batch)
        cfg.queue_max = max(1, cfg.queue_max)
        cfg.flush_max = max(1, cfg.flush_max)
        return cfg


def ingest_config() -> IngestConfig:
    """The event server's ingest knobs (server.json ``ingest`` section <
    env)."""
    return IngestConfig.from_env(read_server_json().get("ingest") or {})


@dataclasses.dataclass
class TrainConfig:
    """Training-solver tuning (server.json ``train`` section, camelCase
    keys; ``PIO_ALS_SOLVER`` / ``PIO_ALS_BLOCK_SIZE`` env overrides).

    ``als_solver`` selects the ALS training solver: ``"full"`` (per-row
    K x K normal equations) or ``"subspace"`` (iALS++ block coordinate
    descent over rank blocks of ``als_block_size``). ``None`` means no
    host-level preference."""

    als_solver: Optional[str] = None       # None | "full" | "subspace"
    als_block_size: Optional[int] = None   # None = solver default (16)

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "TrainConfig":
        """server.json ``train`` section overlaid by env vars (env
        wins); malformed knobs are logged and fall back."""
        data = data or {}
        cfg = cls()

        def as_solver(v):
            s = str(v).strip().lower()
            if s not in ("full", "subspace"):
                raise ValueError(s)
            return s

        sources = (
            ("alsSolver", data.get("alsSolver"), "als_solver", as_solver),
            ("alsBlockSize", data.get("alsBlockSize"), "als_block_size",
             int),
            ("PIO_ALS_SOLVER", os.environ.get("PIO_ALS_SOLVER"),
             "als_solver", as_solver),
            ("PIO_ALS_BLOCK_SIZE", os.environ.get("PIO_ALS_BLOCK_SIZE"),
             "als_block_size", int),
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed train knob %s=%r",
                               name, raw)
        if cfg.als_block_size is not None:
            cfg.als_block_size = max(1, cfg.als_block_size)
        return cfg


DEFAULT_ALS_BLOCK_SIZE = 16


def als_solver_config(algo_solver=None,
                      config: Optional[TrainConfig] = None
                      ) -> "tuple[str, int]":
    """Resolve the (solver_mode, block_size) an ALS train uses.

    ``algo_solver`` is the engine.json algorithm params' ``"solver"``
    section (``{"mode": "full"|"subspace", "block_size": N}`` or a bare
    mode string); it overrides the server.json ``train`` section, and
    ``PIO_ALS_SOLVER`` / ``PIO_ALS_BLOCK_SIZE`` override both, knob by
    knob. A malformed env or file value is logged and ignored; a bad
    mode written in the engine variant raises."""
    if config is None:
        config = TrainConfig.from_env(read_server_json().get("train") or {})
    if isinstance(algo_solver, str):
        algo_solver = {"mode": algo_solver}
    elif algo_solver is not None and not isinstance(algo_solver, dict):
        raise ValueError(
            f"algo params solver must be a mode string or a "
            f'{{"mode", "block_size"}} object, got '
            f"{type(algo_solver).__name__}")
    mode, block = "full", None
    algo_mode = None
    if algo_solver:
        if "mode" in algo_solver:
            algo_mode = str(algo_solver["mode"]).strip().lower()
            if algo_mode not in ("full", "subspace"):
                raise ValueError(
                    f'algo params solver.mode {algo_mode!r}: expected '
                    f'"full" or "subspace"')
            mode = algo_mode
        raw = algo_solver.get("block_size", algo_solver.get("blockSize"))
        if raw is not None:
            block = max(1, int(raw))
        unknown = set(algo_solver) - {"mode", "block_size", "blockSize"}
        if unknown:
            raise ValueError(
                f"unknown solver params {sorted(unknown)}: expected "
                f"mode/block_size")
    if algo_mode is None and config.als_solver is not None:
        mode = config.als_solver
    if block is None and config.als_block_size is not None:
        block = config.als_block_size
    if block is None:
        block = DEFAULT_ALS_BLOCK_SIZE
    # env beats everything, also over a caller's file-built config
    env_cfg = TrainConfig.from_env(None)
    if env_cfg.als_solver is not None:
        mode = env_cfg.als_solver
    if env_cfg.als_block_size is not None:
        block = env_cfg.als_block_size
    return mode, block


@dataclasses.dataclass
class TelemetryConfig:
    """Durable-telemetry tuning (the ``PIO_TELEMETRY*`` knobs;
    server.json ``telemetry`` section, camelCase keys; an engine.json
    top-level ``telemetry`` section overrides the host file, env
    overrides both — the established precedence).

    ``enabled=True`` starts a per-process scrape loop (obs/telemetry.py)
    persisting the registry snapshot plus new flight-recorder records
    into an embedded crash-safe time-series store (obs/tsdb.py) every
    ``interval_s`` — the substrate under ``/history/*.json``, the fleet
    console, ``pio metrics query``, SLO rehydration, and the
    ``PIO_TELEMETRY=0``
    kills the whole loop regardless of file config. Stores live under
    ``dir`` (default ``$PIO_HOME/telemetry``), one subdirectory per
    service so a restarted process continues its own history;
    ``retention_s`` bounds the history (sweep + compaction run on the
    scrape loop), ``segment_max_bytes`` / ``segment_max_age_s`` bound
    the active append segment before it rolls.
    """

    enabled: bool = True
    interval_s: float = 10.0
    retention_s: float = 7 * 86400.0
    dir: Optional[str] = None
    segment_max_bytes: int = 4 << 20
    segment_max_age_s: float = 3600.0

    @classmethod
    def from_env(cls, data: Optional[dict] = None,
                 variant: Optional[dict] = None) -> "TelemetryConfig":
        """Per-knob precedence, weakest first: server.json ``telemetry``
        section (``data``) < engine.json ``telemetry`` section
        (``variant``) < ``PIO_TELEMETRY*`` env. Malformed knobs are
        logged and fall back, same contract as ServingConfig."""
        data = data or {}
        variant = variant or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        file_keys = (
            ("enabled", "enabled", as_bool),
            ("intervalS", "interval_s", float),
            ("retentionS", "retention_s", float),
            ("dir", "dir", str),
            ("segmentMaxBytes", "segment_max_bytes", int),
            ("segmentMaxAgeS", "segment_max_age_s", float),
        )
        env_keys = (
            ("PIO_TELEMETRY", "enabled", as_bool),
            ("PIO_TELEMETRY_INTERVAL_S", "interval_s", float),
            ("PIO_TELEMETRY_RETENTION_S", "retention_s", float),
            ("PIO_TELEMETRY_DIR", "dir", str),
            ("PIO_TELEMETRY_SEGMENT_BYTES", "segment_max_bytes", int),
            ("PIO_TELEMETRY_SEGMENT_AGE_S", "segment_max_age_s", float),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(f"engine.json {k}", variant.get(k), attr, conv)
               for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed telemetry knob %s=%r",
                               name, raw)
        cfg.interval_s = max(0.05, cfg.interval_s)
        cfg.retention_s = max(cfg.interval_s, cfg.retention_s)
        cfg.segment_max_bytes = max(1 << 12, cfg.segment_max_bytes)
        cfg.segment_max_age_s = max(cfg.interval_s, cfg.segment_max_age_s)
        return cfg

    def root_dir(self) -> str:
        """The telemetry root (service stores are subdirectories)."""
        if self.dir:
            return self.dir
        return os.path.join(pio_home(), "telemetry")

    def service_dir(self, service: str) -> str:
        return os.path.join(self.root_dir(), service)


def telemetry_config(variant_section: Optional[dict] = None
                     ) -> TelemetryConfig:
    """Resolve the telemetry knobs a server should run with:
    ``variant_section`` is the engine.json top-level ``telemetry``
    section, which overrides the host-level server.json section; the
    ``PIO_TELEMETRY*`` env vars override both."""
    data = read_server_json().get("telemetry") or {}
    return TelemetryConfig.from_env(data, variant_section)


@dataclasses.dataclass
class BatchPredictConfig:
    """Offline batch-scoring tuning (the ``PIO_BATCHPREDICT_*`` knobs;
    server.json ``batchpredict`` section, camelCase keys).

    ``chunk_size`` is the maximal scoring bucket: chunks pad up the
    power-of-two ladder to it (ops/bucketing), so a run scores at most
    ``bucket_count(chunk_size)`` batch shapes, as serving does.
    ``queue_chunks`` bounds both pipeline queues (reader→
    scorer and scorer→writer), capping host memory at roughly
    ``2 * queue_chunks * chunk_size`` buffered rows. ``pipelined=False``
    runs the same stages inline on one thread (the measurement baseline;
    also the safest setting when debugging an engine's batch_predict).
    ``output_format`` names the format for output paths without a
    recognized extension; an explicit ``--output-format`` flag and a
    recognized extension (``.parquet``/``.pq`` → columnar, ``.jsonl``/
    ``.json``/``.ndjson`` → JSON-lines) both outrank it, so a host-wide
    default can never mislabel an extensioned file. The knob takes the
    reference's values; ``workflow/batch_predict`` refuses ``parquet``
    (not ported yet).
    """

    chunk_size: int = 1024
    queue_chunks: int = 4
    pipelined: bool = True
    output_format: Optional[str] = None   # None | "jsonl" | "parquet"

    @classmethod
    def from_env(cls, data: Optional[dict] = None,
                 variant: Optional[dict] = None) -> "BatchPredictConfig":
        """Per-knob precedence, weakest first: server.json ``batchpredict``
        section (``data``) < engine.json ``batchpredict`` section
        (``variant``) < ``PIO_BATCHPREDICT_*`` env. Malformed knobs are
        logged and fall back, same contract as ServingConfig."""
        data = data or {}
        variant = variant or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")

        def as_format(v):
            s = str(v).strip().lower()
            if s not in ("jsonl", "parquet"):
                raise ValueError(s)
            return s

        sources = (
            ("chunkSize", data.get("chunkSize"), "chunk_size", int),
            ("queueChunks", data.get("queueChunks"), "queue_chunks", int),
            ("pipelined", data.get("pipelined"), "pipelined", as_bool),
            ("outputFormat", data.get("outputFormat"), "output_format",
             as_format),
            ("engine.json chunkSize", variant.get("chunkSize"),
             "chunk_size", int),
            ("engine.json queueChunks", variant.get("queueChunks"),
             "queue_chunks", int),
            ("engine.json pipelined", variant.get("pipelined"),
             "pipelined", as_bool),
            ("engine.json outputFormat", variant.get("outputFormat"),
             "output_format", as_format),
            ("PIO_BATCHPREDICT_CHUNK_SIZE",
             os.environ.get("PIO_BATCHPREDICT_CHUNK_SIZE"),
             "chunk_size", int),
            ("PIO_BATCHPREDICT_QUEUE_CHUNKS",
             os.environ.get("PIO_BATCHPREDICT_QUEUE_CHUNKS"),
             "queue_chunks", int),
            ("PIO_BATCHPREDICT_PIPELINED",
             os.environ.get("PIO_BATCHPREDICT_PIPELINED"),
             "pipelined", as_bool),
            ("PIO_BATCHPREDICT_OUTPUT_FORMAT",
             os.environ.get("PIO_BATCHPREDICT_OUTPUT_FORMAT"),
             "output_format", as_format),
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed batchpredict knob %s=%r",
                               name, raw)
        cfg.chunk_size = max(1, cfg.chunk_size)
        cfg.queue_chunks = max(1, cfg.queue_chunks)
        return cfg


def batchpredict_config(variant_section: Optional[dict] = None
                        ) -> BatchPredictConfig:
    """Resolve the batch-scoring knobs a `pio batchpredict` run should
    use: ``variant_section`` is the engine.json ``batchpredict`` section,
    which overrides the host-level server.json section; the
    ``PIO_BATCHPREDICT_*`` env vars override both (the established
    precedence: env > engine.json > server.json)."""
    data = read_server_json().get("batchpredict") or {}
    return BatchPredictConfig.from_env(data, variant_section)


@dataclasses.dataclass
class OrchestratorConfig:
    """Continuous-training orchestrator tuning (the ``PIO_ORCH_*``
    knobs; server.json ``orchestrator`` section, camelCase keys; an
    engine.json top-level ``orchestrator`` section overrides the host
    file, env overrides both — the established precedence).

    The orchestrator (deploy/orchestrator.py, ``pio orchestrate``) runs
    the closed train → eval-gate → batchpredict-smoke → canary →
    promote loop. ``interval_s`` is the trigger-check cadence;
    ``cooldown_s`` is the minimum gap between one cycle ending and the
    next trigger firing (the flap-suppression window — a trigger
    condition that oscillates cannot thrash retrains faster than this).
    Data-driven triggers: ``min_ingest_events`` fresh events since the
    last cycle's snapshot watermark (0 disables),
    ``foldin_pending_max`` fold-in rows pending (0 disables), and
    ``slo_trigger`` (a burning serving SLO). Each phase runs under
    ``phase_timeout_s`` with ``phase_retries`` retries backed off with
    full jitter from ``phase_backoff_s`` (capped at
    ``phase_backoff_cap_s``); a failed CYCLE backs the next trigger off
    by a jittered exponential from ``cycle_backoff_s`` (capped at
    ``cycle_backoff_cap_s``) on top of the cooldown.
    ``min_eval_score`` gates promotion on the eval sweep's best score
    (None = no bar); ``smoke_queries`` names a query file for the
    batchpredict smoke phase (None skips it); ``canary_hold_s`` is how
    long the registry-plane canary observes the SLO engine before
    judging, while ``canary_verdict_timeout_s`` bounds how long the
    HTTP plane waits for a LIVE query server's own canary verdict
    (sample-count judged — give it time for real traffic) before
    aborting the rollout. ``state_dir`` holds the crash-safe cycle
    documents (default ``$PIO_HOME/orchestrator``).
    """

    interval_s: float = 30.0
    cooldown_s: float = 300.0
    min_ingest_events: int = 500
    foldin_pending_max: int = 0
    slo_trigger: bool = True
    phase_timeout_s: float = 3600.0
    phase_retries: int = 2
    phase_backoff_s: float = 1.0
    phase_backoff_cap_s: float = 30.0
    cycle_backoff_s: float = 60.0
    cycle_backoff_cap_s: float = 3600.0
    min_eval_score: Optional[float] = None
    canary_hold_s: float = 5.0
    canary_verdict_timeout_s: float = 600.0
    #: trailing window the registry-plane canary judge baselines the
    #: candidate's p99/error-rate against, read from the durable
    #: telemetry store (0 disables the history baseline)
    history_window_s: float = 3600.0
    smoke_queries: Optional[str] = None
    state_dir: Optional[str] = None

    @classmethod
    def from_env(cls, data: Optional[dict] = None,
                 variant: Optional[dict] = None) -> "OrchestratorConfig":
        """Per-knob precedence, weakest first: server.json
        ``orchestrator`` section (``data``) < engine.json
        ``orchestrator`` section (``variant``) < ``PIO_ORCH_*`` env.
        Malformed knobs are logged and fall back, same contract as
        ServingConfig."""
        data = data or {}
        variant = variant or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        file_keys = (
            ("intervalS", "interval_s", float),
            ("cooldownS", "cooldown_s", float),
            ("minIngestEvents", "min_ingest_events", int),
            ("foldinPendingMax", "foldin_pending_max", int),
            ("sloTrigger", "slo_trigger", as_bool),
            ("phaseTimeoutS", "phase_timeout_s", float),
            ("phaseRetries", "phase_retries", int),
            ("phaseBackoffS", "phase_backoff_s", float),
            ("phaseBackoffCapS", "phase_backoff_cap_s", float),
            ("cycleBackoffS", "cycle_backoff_s", float),
            ("cycleBackoffCapS", "cycle_backoff_cap_s", float),
            ("minEvalScore", "min_eval_score", float),
            ("canaryHoldS", "canary_hold_s", float),
            ("canaryVerdictTimeoutS", "canary_verdict_timeout_s", float),
            ("historyWindowS", "history_window_s", float),
            ("smokeQueries", "smoke_queries", str),
            ("stateDir", "state_dir", str),
        )
        env_keys = (
            ("PIO_ORCH_INTERVAL_S", "interval_s", float),
            ("PIO_ORCH_COOLDOWN_S", "cooldown_s", float),
            ("PIO_ORCH_MIN_INGEST_EVENTS", "min_ingest_events", int),
            ("PIO_ORCH_FOLDIN_PENDING_MAX", "foldin_pending_max", int),
            ("PIO_ORCH_SLO_TRIGGER", "slo_trigger", as_bool),
            ("PIO_ORCH_PHASE_TIMEOUT_S", "phase_timeout_s", float),
            ("PIO_ORCH_PHASE_RETRIES", "phase_retries", int),
            ("PIO_ORCH_PHASE_BACKOFF_S", "phase_backoff_s", float),
            ("PIO_ORCH_PHASE_BACKOFF_CAP_S", "phase_backoff_cap_s", float),
            ("PIO_ORCH_CYCLE_BACKOFF_S", "cycle_backoff_s", float),
            ("PIO_ORCH_CYCLE_BACKOFF_CAP_S", "cycle_backoff_cap_s", float),
            ("PIO_ORCH_MIN_EVAL_SCORE", "min_eval_score", float),
            ("PIO_ORCH_CANARY_HOLD_S", "canary_hold_s", float),
            ("PIO_ORCH_CANARY_VERDICT_TIMEOUT_S",
             "canary_verdict_timeout_s", float),
            ("PIO_ORCH_HISTORY_WINDOW_S", "history_window_s", float),
            ("PIO_ORCH_SMOKE_QUERIES", "smoke_queries", str),
            ("PIO_ORCH_STATE_DIR", "state_dir", str),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(f"engine.json {k}", variant.get(k), attr, conv)
               for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed orchestrator knob %s=%r",
                               name, raw)
        cfg.interval_s = max(0.01, cfg.interval_s)
        cfg.cooldown_s = max(0.0, cfg.cooldown_s)
        cfg.min_ingest_events = max(0, cfg.min_ingest_events)
        cfg.foldin_pending_max = max(0, cfg.foldin_pending_max)
        cfg.phase_timeout_s = max(0.01, cfg.phase_timeout_s)
        cfg.phase_retries = max(0, cfg.phase_retries)
        cfg.canary_hold_s = max(0.0, cfg.canary_hold_s)
        cfg.canary_verdict_timeout_s = max(1.0,
                                           cfg.canary_verdict_timeout_s)
        cfg.history_window_s = max(0.0, cfg.history_window_s)
        return cfg


def orchestrator_config(variant_section: Optional[dict] = None
                        ) -> OrchestratorConfig:
    """Resolve the orchestrator knobs a `pio orchestrate` run should
    use: ``variant_section`` is the engine.json ``orchestrator``
    section, which overrides the host-level server.json section; the
    ``PIO_ORCH_*`` env vars override both (the established precedence:
    env > engine.json > server.json)."""
    data = read_server_json().get("orchestrator") or {}
    return OrchestratorConfig.from_env(data, variant_section)


@dataclasses.dataclass
class RouterConfig:
    """Serving-fleet router tuning (the ``PIO_ROUTER_*`` knobs;
    server.json ``router`` section, camelCase keys; env overrides the
    file, the established precedence).

    The router (server/router.py, ``pio router``) spreads queries over
    ``replicas`` query-server replicas with the canary error-diffusion
    splitter generalized to N arms — exact realized fractions, no RNG.
    Replicas are health-checked every ``health_interval_s`` against
    their ``/slo.json`` + ``/deploy/status.json``; one leaves rotation
    after ``health_fail_after`` consecutive failures and rejoins on the
    first healthy probe; while it KEEPS failing, its probes back off
    exponentially (interval, 2x, 4x, ... capped at
    ``health_backoff_cap_s``) so a dead port is not hammered at
    ``health_interval_s`` forever — the cap bounds how stale a
    restarted replica's re-admission can be. ``proxy_retries`` is how
    many OTHER replicas a
    failed proxy attempt tries before surfacing the error (a replica
    mid-restart must not fail user queries); ``drain_timeout_s`` bounds
    how long scale-down waits for a draining replica's in-flight
    queries. ``base_port`` seeds spawned replicas' ports (replica rank r
    listens on ``base_port + r``); ``persist_splitter`` restores the
    error-diffusion accumulators from the durable telemetry store on
    restart so a restarted router resumes its exact split mid-stream.
    """

    port: int = 8100
    replicas: int = 2
    base_port: int = 8200
    health_interval_s: float = 2.0
    health_fail_after: int = 3
    health_backoff_cap_s: float = 30.0
    proxy_retries: int = 1
    drain_timeout_s: float = 10.0
    persist_splitter: bool = True

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "RouterConfig":
        """server.json ``router`` section overlaid by ``PIO_ROUTER_*``
        env vars (env wins); malformed knobs are logged and fall back,
        same contract as ServingConfig."""
        data = data or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        file_keys = (
            ("port", "port", int),
            ("replicas", "replicas", int),
            ("basePort", "base_port", int),
            ("healthIntervalS", "health_interval_s", float),
            ("healthFailAfter", "health_fail_after", int),
            ("healthBackoffCapS", "health_backoff_cap_s", float),
            ("proxyRetries", "proxy_retries", int),
            ("drainTimeoutS", "drain_timeout_s", float),
            ("persistSplitter", "persist_splitter", as_bool),
        )
        env_keys = (
            ("PIO_ROUTER_PORT", "port", int),
            ("PIO_ROUTER_REPLICAS", "replicas", int),
            ("PIO_ROUTER_BASE_PORT", "base_port", int),
            ("PIO_ROUTER_HEALTH_INTERVAL_S", "health_interval_s", float),
            ("PIO_ROUTER_HEALTH_FAIL_AFTER", "health_fail_after", int),
            ("PIO_ROUTER_HEALTH_BACKOFF_CAP_S", "health_backoff_cap_s",
             float),
            ("PIO_ROUTER_PROXY_RETRIES", "proxy_retries", int),
            ("PIO_ROUTER_DRAIN_TIMEOUT_S", "drain_timeout_s", float),
            ("PIO_ROUTER_PERSIST_SPLITTER", "persist_splitter", as_bool),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed router knob %s=%r",
                               name, raw)
        cfg.replicas = max(1, cfg.replicas)
        cfg.health_interval_s = max(0.05, cfg.health_interval_s)
        cfg.health_fail_after = max(1, cfg.health_fail_after)
        # the cap can never undercut one interval (backoff only grows)
        cfg.health_backoff_cap_s = max(cfg.health_interval_s,
                                       cfg.health_backoff_cap_s)
        cfg.proxy_retries = max(0, cfg.proxy_retries)
        cfg.drain_timeout_s = max(0.0, cfg.drain_timeout_s)
        return cfg


def router_config() -> RouterConfig:
    """Resolve the router knobs a ``pio router`` run should use:
    server.json ``router`` section overlaid by ``PIO_ROUTER_*`` env."""
    return RouterConfig.from_env(read_server_json().get("router") or {})


@dataclasses.dataclass
class FleetConfig:
    """SLO-driven autoscaling tuning (the ``PIO_FLEET_*`` knobs;
    server.json ``fleet`` section, camelCase keys; env overrides the
    file, the established precedence).

    The fleet controller (deploy/fleet.py) runs inside the router
    process and drives replica count off the durable SLO burn-rate
    history through the orchestrator's committed-phase-transition
    discipline: scale UP one replica once the serving SLO has burned
    for ``burn_sustain_s`` continuously (to at most ``max_replicas``),
    scale DOWN one replica once fleet-wide QPS has sat under
    ``idle_qps`` for ``idle_sustain_s`` (to at least ``min_replicas``;
    the victim drains before it stops — zero dropped queries is the
    contract). ``cooldown_s`` separates consecutive scaling decisions
    (flap suppression); ``state_dir`` holds the crash-safe fleet
    documents (default ``$PIO_HOME/fleet``).
    """

    enabled: bool = True
    min_replicas: int = 1
    max_replicas: int = 4
    burn_sustain_s: float = 30.0
    idle_qps: float = 0.5
    idle_sustain_s: float = 120.0
    cooldown_s: float = 60.0
    state_dir: Optional[str] = None

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "FleetConfig":
        """server.json ``fleet`` section overlaid by ``PIO_FLEET_*``
        env vars (env wins); malformed knobs are logged and fall back,
        same contract as ServingConfig."""
        data = data or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        file_keys = (
            ("enabled", "enabled", as_bool),
            ("minReplicas", "min_replicas", int),
            ("maxReplicas", "max_replicas", int),
            ("burnSustainS", "burn_sustain_s", float),
            ("idleQps", "idle_qps", float),
            ("idleSustainS", "idle_sustain_s", float),
            ("cooldownS", "cooldown_s", float),
            ("stateDir", "state_dir", str),
        )
        env_keys = (
            ("PIO_FLEET_AUTOSCALE", "enabled", as_bool),
            ("PIO_FLEET_MIN_REPLICAS", "min_replicas", int),
            ("PIO_FLEET_MAX_REPLICAS", "max_replicas", int),
            ("PIO_FLEET_BURN_SUSTAIN_S", "burn_sustain_s", float),
            ("PIO_FLEET_IDLE_QPS", "idle_qps", float),
            ("PIO_FLEET_IDLE_SUSTAIN_S", "idle_sustain_s", float),
            ("PIO_FLEET_COOLDOWN_S", "cooldown_s", float),
            ("PIO_FLEET_STATE_DIR", "state_dir", str),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed fleet knob %s=%r",
                               name, raw)
        cfg.min_replicas = max(1, cfg.min_replicas)
        cfg.max_replicas = max(cfg.min_replicas, cfg.max_replicas)
        cfg.burn_sustain_s = max(0.0, cfg.burn_sustain_s)
        cfg.idle_qps = max(0.0, cfg.idle_qps)
        cfg.idle_sustain_s = max(0.0, cfg.idle_sustain_s)
        cfg.cooldown_s = max(0.0, cfg.cooldown_s)
        return cfg

    def resolved_state_dir(self) -> str:
        if self.state_dir:
            return self.state_dir
        return os.path.join(pio_home(), "fleet")


def fleet_config() -> FleetConfig:
    """Resolve the autoscaler knobs a fleet controller should use:
    server.json ``fleet`` section overlaid by ``PIO_FLEET_*`` env."""
    return FleetConfig.from_env(read_server_json().get("fleet") or {})


@dataclasses.dataclass
class MultiTenantConfig:
    """Multi-tenant host tuning (the ``PIO_MT_*`` knobs; server.json
    ``multitenant`` section, camelCase keys; env overrides the file,
    the established precedence).

    ``budget_bytes`` is the shared device-memory residency budget the
    host keeps all tenants' scorer factors under (0 = unlimited: never
    evict). ``reload_wait_s`` bounds how long a query hitting a warm
    (evicted) tenant waits for the warm-reload ladder before a clean
    503. ``sweep_interval_s`` paces the background LRU budget sweep,
    ``min_resident`` is the floor the sweep never evicts below,
    ``admission`` arms the per-tenant SLO-burn 429 path and
    ``retry_after_s`` is the Retry-After it advertises.
    ``max_tenant_series`` caps the per-metric series the ``tenant``
    label may create before new tenants collapse into the registry's
    ``other`` overflow bucket (established tenants keep their series).
    """

    budget_bytes: int = 0
    reload_wait_s: float = 10.0
    sweep_interval_s: float = 2.0
    min_resident: int = 1
    admission: bool = True
    retry_after_s: float = 1.0
    max_tenant_series: int = 256

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "MultiTenantConfig":
        """server.json ``multitenant`` section overlaid by ``PIO_MT_*``
        env vars (env wins); malformed knobs are logged and fall back,
        same contract as ServingConfig."""
        data = data or {}
        cfg = cls()
        as_bool = lambda v: str(v).strip().lower() not in (  # noqa: E731
            "0", "false", "no", "off", "")
        file_keys = (
            ("budgetBytes", "budget_bytes", int),
            ("reloadWaitS", "reload_wait_s", float),
            ("sweepIntervalS", "sweep_interval_s", float),
            ("minResident", "min_resident", int),
            ("admission", "admission", as_bool),
            ("retryAfterS", "retry_after_s", float),
            ("maxTenantSeries", "max_tenant_series", int),
        )
        env_keys = (
            ("PIO_MT_DEVICE_BUDGET_BYTES", "budget_bytes", int),
            ("PIO_MT_RELOAD_WAIT_S", "reload_wait_s", float),
            ("PIO_MT_SWEEP_INTERVAL_S", "sweep_interval_s", float),
            ("PIO_MT_MIN_RESIDENT", "min_resident", int),
            ("PIO_MT_ADMISSION", "admission", as_bool),
            ("PIO_MT_RETRY_AFTER_S", "retry_after_s", float),
            ("PIO_MT_MAX_TENANT_SERIES", "max_tenant_series", int),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed multitenant knob %s=%r",
                               name, raw)
        cfg.budget_bytes = max(0, cfg.budget_bytes)
        cfg.reload_wait_s = max(0.1, cfg.reload_wait_s)
        cfg.sweep_interval_s = max(0.05, cfg.sweep_interval_s)
        cfg.min_resident = max(0, cfg.min_resident)
        cfg.retry_after_s = max(0.0, cfg.retry_after_s)
        cfg.max_tenant_series = max(1, cfg.max_tenant_series)
        return cfg


def multitenant_config() -> MultiTenantConfig:
    """Resolve the multi-tenant host knobs: server.json ``multitenant``
    section overlaid by ``PIO_MT_*`` env."""
    return MultiTenantConfig.from_env(
        read_server_json().get("multitenant") or {})


@dataclasses.dataclass
class LoadtestConfig:
    """Workload-simulator tuning (the ``PIO_LOADTEST_*`` knobs;
    server.json ``loadtest`` section, camelCase keys; env wins).

    They scale a scenario file without editing it: ``population`` and
    ``duration_s`` replace the scenario's own values when set (> 0),
    ``rate_scale`` multiplies its arrival rate, ``seed`` re-seeds the run
    (>= 0), ``max_outstanding`` bounds the open-loop in-flight window of
    each lane (> 0), and ``report_dir`` is where ``pio loadtest`` writes
    the verdict JSON (empty: standard output only)."""

    population: int = 0
    duration_s: float = 0.0
    rate_scale: float = 1.0
    seed: int = -1
    max_outstanding: int = 0
    report_dir: str = ""

    @classmethod
    def from_env(cls, data: Optional[dict] = None) -> "LoadtestConfig":
        """server.json ``loadtest`` section overlaid by
        ``PIO_LOADTEST_*`` env vars (env wins); malformed knobs are
        logged and fall back."""
        data = data or {}
        cfg = cls()
        file_keys = (
            ("population", "population", int),
            ("durationS", "duration_s", float),
            ("rateScale", "rate_scale", float),
            ("seed", "seed", int),
            ("maxOutstanding", "max_outstanding", int),
            ("reportDir", "report_dir", str),
        )
        env_keys = (
            ("PIO_LOADTEST_POPULATION", "population", int),
            ("PIO_LOADTEST_DURATION_S", "duration_s", float),
            ("PIO_LOADTEST_RATE_SCALE", "rate_scale", float),
            ("PIO_LOADTEST_SEED", "seed", int),
            ("PIO_LOADTEST_OUTSTANDING", "max_outstanding", int),
            ("PIO_LOADTEST_REPORT_DIR", "report_dir", str),
        )
        sources = (
            [(k, data.get(k), attr, conv) for k, attr, conv in file_keys]
            + [(k, os.environ.get(k), attr, conv)
               for k, attr, conv in env_keys]
        )
        for name, raw, attr, conv in sources:
            if raw is None or raw == "":
                continue
            try:
                setattr(cfg, attr, conv(raw))
            except (TypeError, ValueError):
                logger.warning("ignoring malformed loadtest knob %s=%r",
                               name, raw)
        cfg.population = max(0, cfg.population)
        cfg.duration_s = max(0.0, cfg.duration_s)
        cfg.rate_scale = max(0.0, cfg.rate_scale)
        cfg.max_outstanding = max(0, cfg.max_outstanding)
        return cfg

    def apply(self, scenario):
        """Overlay the set knobs onto a Scenario in place and return it
        (0 or negative: keep the scenario's own value)."""
        if self.population > 0:
            scenario.population = self.population
        if self.duration_s > 0:
            scenario.duration_s = self.duration_s
        if self.rate_scale > 0 and self.rate_scale != 1.0:
            scenario.base_rate = scenario.base_rate * self.rate_scale
        if self.seed >= 0:
            scenario.seed = self.seed
        if self.max_outstanding > 0:
            scenario.max_outstanding = self.max_outstanding
        return scenario


def loadtest_config() -> LoadtestConfig:
    """The knobs a ``pio loadtest`` run uses: server.json ``loadtest``
    section overlaid by ``PIO_LOADTEST_*`` env."""
    return LoadtestConfig.from_env(read_server_json().get("loadtest") or {})


@dataclasses.dataclass
class ServerConfig:
    """server.json as a whole: the access key, TLS and every section a
    server resolves (the reference's ``ServerConfig``)."""

    key: str = ""
    ssl_enabled: bool = False
    certfile: Optional[str] = None
    keyfile: Optional[str] = None
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    deploy: DeployConfig = dataclasses.field(default_factory=DeployConfig)
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    foldin: FoldinConfig = dataclasses.field(default_factory=FoldinConfig)
    scorer: ScorerConfig = dataclasses.field(default_factory=ScorerConfig)
    batchpredict: BatchPredictConfig = dataclasses.field(
        default_factory=BatchPredictConfig)
    orchestrator: OrchestratorConfig = dataclasses.field(
        default_factory=OrchestratorConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    multitenant: MultiTenantConfig = dataclasses.field(
        default_factory=MultiTenantConfig)

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ServerConfig":
        """Read server.json and overlay the env; no file: defaults."""
        data = read_server_json(path)
        ssl_conf = data.get("ssl", {}) or {}
        cfg = cls(
            key=data.get("key", "") or "",
            ssl_enabled=bool(ssl_conf.get("enabled", False)),
            certfile=ssl_conf.get("certfile"),
            keyfile=ssl_conf.get("keyfile"),
            serving=ServingConfig.from_env(data.get("serving") or {}),
            deploy=DeployConfig.from_env(data.get("deploy") or {}),
            ingest=IngestConfig.from_env(data.get("ingest") or {}),
            train=TrainConfig.from_env(data.get("train") or {}),
            foldin=FoldinConfig.from_env(data.get("foldin") or {}),
            scorer=ScorerConfig.from_env(data.get("scorer") or {}),
            batchpredict=BatchPredictConfig.from_env(
                data.get("batchpredict") or {}),
            orchestrator=OrchestratorConfig.from_env(
                data.get("orchestrator") or {}),
            telemetry=TelemetryConfig.from_env(
                data.get("telemetry") or {}),
            multitenant=MultiTenantConfig.from_env(
                data.get("multitenant") or {}),
        )
        if os.environ.get("PIO_SERVER_KEY"):
            cfg.key = os.environ["PIO_SERVER_KEY"]
        if os.environ.get("PIO_SSL_CERTFILE"):
            cfg.certfile = os.environ["PIO_SSL_CERTFILE"]
            cfg.ssl_enabled = True
        if os.environ.get("PIO_SSL_KEYFILE"):
            cfg.keyfile = os.environ["PIO_SSL_KEYFILE"]
        return cfg

    def check_key(self, provided: Optional[str]) -> bool:
        """No configured key: open access; else ``provided`` must match
        (compared in constant time)."""
        if not self.key:
            return True
        return hmac.compare_digest(provided or "", self.key)

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        """The listener's TLS context from the PEM certificate and key,
        or None when TLS is off or a file is not named."""
        if not (self.ssl_enabled and self.certfile and self.keyfile):
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile=self.certfile, keyfile=self.keyfile)
        return ctx
