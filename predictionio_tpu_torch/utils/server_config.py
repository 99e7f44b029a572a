"""Scorer, ingest, training-solver, fold-in, deploy and batch-predict
knobs: the ``scorer``, ``ingest``, ``train``, ``foldin``, ``deploy`` and
``batchpredict`` sections of the reference's ``utils/server_config.py``
(``ScorerConfig``, ``scorer_config``, ``IngestConfig``, ``TrainConfig``,
``als_solver_config``, ``FoldinConfig``, ``foldin_config``,
``DeployConfig``, ``deploy_config``, ``BatchPredictConfig``,
``batchpredict_config``), with their precedence unchanged —
server.json section < engine.json (the top-level ``scorer``, ``foldin``
and ``batchpredict`` sections, the algorithm's ``solver`` params) <
``PIO_SCORER_*`` / ``PIO_INGEST_*`` / ``PIO_ALS_*`` / ``PIO_FOLDIN*`` /
``PIO_DEPLOY_*`` / ``PIO_CANARY_*`` / ``PIO_BATCHPREDICT_*``
environment.

The server.json path is resolved as the reference resolves it:
``PIO_SERVER_CONF``, else ``$PIO_CONF_DIR/server.json``, else
``$PIO_HOME/conf/server.json``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

logger = logging.getLogger("pio.torch.config")

SCORER_MODES = ("exact", "fused", "fused_bf16", "fused_int8", "twostage")


def pio_home() -> str:
    return os.environ.get(
        "PIO_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu"))


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

    ``shards`` > 1 (model-parallel serving over several cards) belongs to
    the multi-GPU slice of the port: resolving it raises
    ``NotImplementedError``.
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
        check_unsharded(cfg)
        return cfg

    def cache_key(self) -> tuple:
        """What invalidates a built scorer when the config changes."""
        return (self.mode, self.tile_items, self.shortlist,
                self.min_recall, self.shards)


def check_unsharded(cfg: ScorerConfig) -> None:
    """Sharded serving is not ported yet: refuse it instead of silently
    serving one shard's worth of behaviour."""
    if int(cfg.shards or 1) > 1:
        raise NotImplementedError(
            f"scorer shards={cfg.shards}: model-parallel serving "
            "(ShardedScorer) is not ported to PyTorch yet")


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
    caps ``/batch/events.json`` (EventServer.scala:66). ``partitions`` >
    1 (parallel commit lanes over a partitioned store) is not ported:
    resolving it raises ``NotImplementedError``."""

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
    env). Partitioned ingest is refused, not run as one lane."""
    cfg = IngestConfig.from_env(read_server_json().get("ingest") or {})
    if cfg.partitions > 1:
        raise NotImplementedError(
            f"ingest partitions={cfg.partitions}: the partitioned event "
            "store and its parallel commit lanes are not ported to "
            "PyTorch yet")
    return cfg


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
