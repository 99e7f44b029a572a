"""Scorer and training-solver knobs: the ``scorer`` and ``train``
sections of the reference's ``utils/server_config.py`` (``ScorerConfig``,
``scorer_config``, ``TrainConfig``, ``als_solver_config``), with their
precedence unchanged — server.json section < engine.json (the top-level
``scorer`` section, the algorithm's ``solver`` params) < ``PIO_SCORER_*``
/ ``PIO_ALS_*`` environment.

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
