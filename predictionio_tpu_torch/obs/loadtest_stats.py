"""Loadtest metrics (port of the reference's ``obs/loadtest_stats.py``):
the storm's own offered-vs-observed accounting.

The simulator (loadtest/simulator.py) is itself instrumented like a
production client fleet, so a storm's progress and verdict are
scrapeable mid-run from the same registry surface every server
exposes:

* ``pio_loadtest_offered_total{lane}`` — items offered per lane
  (``events`` are counted per event even when batched, ``queries`` /
  ``feedback`` per request).
* ``pio_loadtest_acked_total{lane}`` / ``pio_loadtest_failed_total{lane}``
  — resolved acks and hard failures per lane; offered − acked − failed
  is the in-flight window, and a non-zero residue at the end of the
  run is the dropped-ack invariant violation.
* ``pio_loadtest_ack_seconds`` — ingest ack latency, submit → the
  WriteBuffer/event-server future resolving (the open-loop harness's
  headline distribution).
* ``pio_loadtest_query_seconds`` — query round-trip through the router.
* ``pio_loadtest_incidents_total{kind}`` — injected incidents by kind
  (``kill_replica`` / ``kill_compaction`` / ``burn_slo`` /
  ``degrade_quality`` / ``retrain``); each also records a
  ``loadtest_incident`` flight-recorder event carrying the storm's
  trace id, so one incident can be followed router → replica → device.
* ``pio_loadtest_invariant_checks_total{invariant,outcome}`` — runtime
  invariant verdicts (outcome ``ok`` / ``violated``): the `pio check`
  guarantees asserted as live facts.
* ``pio_loadtest_active_users`` — synthetic users that materialised
  session state so far (the lazy population's working set).
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry, exponential_buckets,
)

#: 1 ms .. ~32 s doubling — ack + query round-trips under load
LATENCY_BUCKETS = exponential_buckets(0.001, 2.0, 16)


def loadtest_offered(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_loadtest_offered_total",
        "Loadtest items offered per lane (open-loop schedule)",
        labelnames=("lane",))


def loadtest_acked(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_loadtest_acked_total",
        "Loadtest items acknowledged per lane",
        labelnames=("lane",))


def loadtest_failed(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_loadtest_failed_total",
        "Loadtest items that resolved with a hard failure, per lane",
        labelnames=("lane",))


def loadtest_ack_seconds(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_loadtest_ack_seconds",
        "Ingest ack latency: submit -> acknowledged (open loop)",
        buckets=LATENCY_BUCKETS)


def loadtest_query_seconds(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_loadtest_query_seconds",
        "Query round-trip latency through the router",
        buckets=LATENCY_BUCKETS)


def loadtest_incidents(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_loadtest_incidents_total",
        "Injected chaos incidents by kind",
        labelnames=("kind",))


def loadtest_invariant_checks(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_loadtest_invariant_checks_total",
        "Runtime invariant verdicts by invariant and outcome",
        labelnames=("invariant", "outcome"))


def loadtest_active_users(registry: MetricsRegistry = None):
    return (registry or default_registry()).gauge(
        "pio_loadtest_active_users",
        "Synthetic users with materialised session state")
