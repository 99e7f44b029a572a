"""Scoring-kernel metric handles (ops/scoring.py).

The fused/two-stage top-k layer accounts its work here: how many item
tiles streamed, how big the two-stage shortlists run (and what fraction
of the catalog gets the exact rescore), how lossy the resident
quantization is, and — the safety-valve counter — how often a built
scorer failed its recall parity gate and fell back to exact serving.
The series are the reference's (``obs/scoring_stats.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from predictionio_tpu_torch.obs.registry import MetricsRegistry, default_registry


@dataclasses.dataclass
class ScoringMetrics:
    batches: Any            # pio_scoring_batches_total{mode}
    tiles: Any              # pio_scoring_tiles_total
    shortlist: Any          # pio_scoring_shortlist_size
    rescore_fraction: Any   # pio_scoring_rescore_fraction
    quant_error: Any        # pio_scoring_quant_error{mode}
    parity_recall: Any      # pio_scoring_parity_recall{mode}
    parity_fallback: Any    # pio_scoring_parity_fallback_total{mode}


#: memoized default-registry handles: ItemScorer.topk runs per serving
#: micro-batch, and re-resolving seven metrics through the registry
#: lock per batch would put the observability layer on the hot path the
#: scoring kernel exists to shorten
_DEFAULT: Optional[ScoringMetrics] = None
_DEFAULT_REG: Optional[MetricsRegistry] = None


def scoring_metrics(registry: Optional[MetricsRegistry] = None
                    ) -> ScoringMetrics:
    """Get-or-create the scoring metric family on `registry`
    (idempotent; the default-registry resolution is memoized)."""
    global _DEFAULT, _DEFAULT_REG
    reg = registry or default_registry()
    if reg is _DEFAULT_REG:
        return _DEFAULT
    metrics = _build(reg)
    if registry is None:
        _DEFAULT, _DEFAULT_REG = metrics, reg
    return metrics


def _build(reg: MetricsRegistry) -> ScoringMetrics:
    return ScoringMetrics(
        batches=reg.counter(
            "pio_scoring_batches_total",
            "Device-scored top-k batches by active scorer mode",
            labelnames=("mode",)),
        tiles=reg.counter(
            "pio_scoring_tiles_total",
            "Item tiles streamed through the fused scoring kernels"),
        shortlist=reg.histogram(
            "pio_scoring_shortlist_size",
            "Two-stage shortlist candidates per query batch"),
        rescore_fraction=reg.histogram(
            "pio_scoring_rescore_fraction",
            "Fraction of the catalog the two-stage exact rescore "
            "touches (shortlist / n_items)",
            buckets=(0.0001, 0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0)),
        quant_error=reg.gauge(
            "pio_scoring_quant_error",
            "Sampled max relative dequantization error of the resident "
            "quantized factors, by scorer mode",
            labelnames=("mode",)),
        parity_recall=reg.gauge(
            "pio_scoring_parity_recall",
            "Build-time recall@10 of the scorer vs the exact path "
            "(the parity-gate probe), by scorer mode",
            labelnames=("mode",)),
        parity_fallback=reg.counter(
            "pio_scoring_parity_fallback_total",
            "Scorer builds whose parity probe missed min_recall and "
            "fell back to exact serving",
            labelnames=("mode",)),
    )
