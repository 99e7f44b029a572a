"""Offline batch-scoring metrics: throughput, padding waste, input health
(a copy of the reference's ``obs/batch_stats.py``).

`pio batchpredict` is the throughput complement of the serving hot path,
so its accounting mirrors the serving metrics but is judged in rows/s
rather than request latency:

* ``pio_batchpredict_queries_total`` — queries scored (pad rows NOT
  counted; they are accounted separately as waste).
* ``pio_batchpredict_invalid_queries_total`` — input rows skipped as
  malformed (unparseable JSON, queries that do not fit the engine's
  query class, or rows the engine failed on). Every increment has a
  matching record in the run's ``.errors.jsonl`` sidecar.
* ``pio_batchpredict_rows_per_second`` — end-to-end throughput of the
  most recent run on this process (written rows / wall seconds).
* ``pio_batchpredict_chunk_seconds`` — per-chunk scoring wall time (the
  scorer stage only; read/write ride the ``batchpredict_read`` /
  ``batchpredict_write`` spans).
* ``pio_batchpredict_pad_waste_rows_total`` — throwaway rows added
  padding chunks up to their power-of-two bucket. The batch path scores
  at the configured MAXIMAL bucket with no linger, so padding is the
  only throughput tax the shape discipline charges — against throughput
  here, where serving charges it against latency.

Stage timings ride the shared ``span()`` API as ``batchpredict_*`` spans
(``pio_span_duration_seconds{span=...}``).
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry, exponential_buckets,
)

#: 1 ms .. ~2 min doubling — one scored chunk, not a whole run
CHUNK_BUCKETS = exponential_buckets(0.001, 2.0, 17)


def batch_queries_counter(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_batchpredict_queries_total",
        "Queries scored by offline batch-predict runs")


def batch_invalid_counter(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_batchpredict_invalid_queries_total",
        "Input rows skipped as malformed/failed (each has a sidecar "
        "error record)")


def batch_rows_per_second(registry: MetricsRegistry = None):
    return (registry or default_registry()).gauge(
        "pio_batchpredict_rows_per_second",
        "End-to-end throughput of the most recent batch-predict run")


def batch_chunk_seconds(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_batchpredict_chunk_seconds",
        "Per-chunk scoring wall time (scorer stage only)",
        buckets=CHUNK_BUCKETS)


def batch_pad_waste(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_batchpredict_pad_waste_rows_total",
        "Throwaway rows added padding batch-predict chunks up to their "
        "shape bucket (the throughput price of a bounded compile set)")
