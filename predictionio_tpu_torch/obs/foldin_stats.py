"""Online fold-in metrics: the event→serving freshness loop's gauges.

The fold-in controller (deploy/foldin.py) turns fresh events into
updated factor rows between full retrains; these metrics make its
headline number — seconds from event ingested to reflected in
recommendations — observable in production:

* ``pio_foldin_pending_rows`` — entity rows (users + items) dirtied by
  fresh events and waiting for the next apply. Grows past
  ``max_pending`` under sustained load = the apply cadence is too slow
  for the stream.
* ``pio_foldin_batch_rows`` — rows folded per batched device solve
  (the B of the one-program solve; compare against pending to see
  whether applies keep up).
* ``pio_foldin_solve_seconds`` — wall time of one batched device solve
  (pack + dispatch + fetch). The freshness bound is
  ``apply_interval_s`` + this.
* ``pio_foldin_apply_seconds`` — wall time of one whole apply (pull
  scan + per-entity history reads + solve + swap).
* ``pio_foldin_applied_rows_total{side}`` — factor rows folded into the
  live ServingUnit, by side (``user`` / ``item``).
* ``pio_foldin_applies_total{outcome}`` — apply ticks by outcome
  (``applied`` / ``empty`` / ``error`` / ``raced`` — a deploy cutover
  won the compare-and-swap mid-solve; deltas requeued).
* ``pio_foldin_event_to_applied_seconds`` — the headline: seconds from
  an event first reaching the controller (push tap or pull scan) to the
  swap that made it visible to queries, one observation per applied
  entity.

The serving-time per-entity lookup cache (engines/common.py
``EntityEventCache`` — the e-commerce business-rule hot path) counts:

* ``pio_serving_entity_cache_hits_total{lookup}`` /
  ``pio_serving_entity_cache_misses_total{lookup}`` — short-TTL cache
  hits/misses per lookup kind (``recent_items`` / ``seen`` /
  ``constraint``): a miss is one columnar event-store read on the
  query path.
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry, exponential_buckets,
)

#: 1 ms .. ~1 min doubling — a batched fold-in solve / apply tick
SOLVE_BUCKETS = exponential_buckets(0.001, 2.0, 16)
#: 10 ms .. ~80 s doubling — event→applied freshness (bounded by the
#: apply interval + one solve, so sub-second to tens of seconds)
FRESHNESS_BUCKETS = exponential_buckets(0.01, 2.0, 14)


def foldin_pending(registry: MetricsRegistry = None):
    return (registry or default_registry()).gauge(
        "pio_foldin_pending_rows",
        "Entity rows dirtied by fresh events, waiting for the next "
        "fold-in apply")


def foldin_batch_rows(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_foldin_batch_rows",
        "Rows folded per batched device solve",
        buckets=tuple(float(1 << i) for i in range(13)))


def foldin_solve_seconds(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_foldin_solve_seconds",
        "Wall time of one batched fold-in device solve",
        buckets=SOLVE_BUCKETS)


def foldin_apply_seconds(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_foldin_apply_seconds",
        "Wall time of one fold-in apply tick (pull + reads + solve + "
        "swap)", buckets=SOLVE_BUCKETS)


def foldin_applied_rows(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_foldin_applied_rows_total",
        "Factor rows folded into the live ServingUnit, by side",
        labelnames=("side",))


def foldin_applies(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_foldin_applies_total",
        "Fold-in apply ticks by outcome (applied/empty/error/raced)",
        labelnames=("outcome",))


def foldin_event_to_applied(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_foldin_event_to_applied_seconds",
        "Seconds from an event reaching the fold-in controller to the "
        "swap that made it visible to queries",
        buckets=FRESHNESS_BUCKETS)


def entity_cache_hits(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_serving_entity_cache_hits_total",
        "Serving-time per-entity event lookups served from the "
        "short-TTL cache, by lookup kind", labelnames=("lookup",))


def entity_cache_misses(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_serving_entity_cache_misses_total",
        "Serving-time per-entity event lookups that read the event "
        "store (columnar find), by lookup kind", labelnames=("lookup",))
