"""Scorer knobs: the ``scorer`` section of the reference's
``utils/server_config.py`` (``ScorerConfig``, ``scorer_config``), with its
precedence unchanged — server.json ``scorer`` section < engine.json
top-level ``scorer`` section < ``PIO_SCORER_*`` environment.

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
