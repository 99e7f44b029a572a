"""The durable-telemetry scrape loop + the /history read surface (the
reference's ``obs/telemetry.py``; its routes are ``server/http`` ones).

Every server process runs ONE :class:`TelemetryRecorder` (wired by the
``run_*`` entry points when ``TelemetryConfig.enabled``; tests construct
them explicitly): a background thread that every ``interval_s``

* snapshots the process's metric registries (the server's own merged
  with :func:`obs.default_registry`, first definition of a name wins —
  the same merge `/metrics` renders) into the embedded crash-safe store
  (obs/tsdb.py) under ``<telemetry root>/<service>/``, and
* drains the flight recorder's NEW trace/lifecycle records into the
  same store (cursor-based tail — nothing is persisted twice),

then rolls/sweeps/compacts the store on the same thread (single writer
per directory, the tsdb contract). On graceful shutdown ``stop()``
drains a final snapshot plus the remaining ring records, so completed
traces and lifecycle events survive the process (a SIGKILL loses at
most one interval). On startup :meth:`restore_recorder` reloads the
most recent persisted rings back into the in-memory flight recorder —
``pio traces`` on a freshly restarted server still shows yesterday's
deploys.

``history_routes`` gives the read surface every server shares:

* ``GET /history/series.json`` — the persisted series inventory
* ``GET /history/range.json?name=...&sinceS=...[&rate=1]
  [&quantile=0.99][&labels={...}]`` — raw samples, rate(), or
  histogram-quantile-over-time across the whole local fleet's stores

backed by a :class:`tsdb.TSDBReader` over the telemetry ROOT (every
service's store, each labeled with its ``process``), so any one server
answers for the whole host.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry, exponential_buckets,
)
from predictionio_tpu_torch.obs.trace_context import recorder
from predictionio_tpu_torch.obs.tsdb import TSDB, TSDBReader
from predictionio_tpu_torch.utils.server_config import TelemetryConfig

logger = logging.getLogger("pio.telemetry")

#: flight-recorder records restored into memory at startup (bounded by
#: the ring capacity anyway; this bounds the readback scan)
RESTORE_LIMIT = 256

#: 1 ms .. ~2 s doubling — one scrape = snapshot + a few appends
SCRAPE_BUCKETS = exponential_buckets(0.001, 2.0, 12)


class TelemetryRecorder:
    """One process's durable-telemetry loop (see module docstring)."""

    def __init__(self, service: str, config: TelemetryConfig,
                 registries: Optional[List[MetricsRegistry]] = None,
                 flight=None):
        self.service = service
        self.cfg = config
        self.registries = list(registries or [default_registry()])
        self._flight = flight if flight is not None else recorder()
        self.db = TSDB(config.service_dir(service),
                       retention_s=config.retention_s,
                       segment_max_bytes=config.segment_max_bytes,
                       segment_max_age_s=config.segment_max_age_s)
        self._trace_cursor = 0
        self._event_cursor = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = self.registries[0]
        self._scrapes = reg.counter(
            "pio_telemetry_scrapes_total",
            "Telemetry persistence ticks by outcome",
            labelnames=("status",))
        self._scrape_hist = reg.histogram(
            "pio_telemetry_scrape_duration_seconds",
            "Wall time of one telemetry persistence tick",
            buckets=SCRAPE_BUCKETS)
        self._samples = reg.counter(
            "pio_telemetry_samples_total",
            "Samples appended to the local time-series store")
        self._segments = reg.gauge(
            "pio_telemetry_segments",
            "Sealed segments in this process's telemetry store")
        self._segment_bytes = reg.gauge(
            "pio_telemetry_segment_bytes",
            "Bytes in the active (append) telemetry segment")
        self._compactions = reg.counter(
            "pio_telemetry_compactions_total",
            "Telemetry segment compactions (inputs merged per run)")
        self._swept = reg.counter(
            "pio_telemetry_swept_segments_total",
            "Telemetry segments dropped by the retention sweep")

    # -- readback ------------------------------------------------------------
    def reader(self) -> TSDBReader:
        """This process's OWN store (the fleet view lives in
        obs/fleet.history_reader over the telemetry root)."""
        return TSDBReader([self.db.dir])

    def restore_recorder(self) -> int:
        """Reload the most recent persisted flight-recorder records into
        the in-memory rings, so /debug/traces.json (and `pio traces`)
        survives the restart. Cursors advance past the imports — the
        next persist tick never writes a restored record back."""
        since = int((time.time() - self.cfg.retention_s) * 1000)
        rdr = self.reader()
        traces = [t for _ts, t in rdr.traces(since_ms=since)][-RESTORE_LIMIT:]
        events = [e for _ts, e in rdr.events(since_ms=since)][-RESTORE_LIMIT:]
        if traces or events:
            self._flight.import_records(traces, events)
        _t, _e, self._trace_cursor, self._event_cursor = \
            self._flight.tail(1 << 62, 1 << 62)
        return len(traces) + len(events)

    # -- the persistence tick ------------------------------------------------
    def _merged_snapshot(self) -> Dict[str, dict]:
        merged: Dict[str, dict] = {}
        for reg in self.registries:
            for name, entry in reg.to_snapshot().items():
                if name.startswith("pio_"):
                    merged.setdefault(name, entry)
        return merged

    def scrape_once(self, ts_ms: Optional[int] = None) -> int:
        """One persistence tick (the loop's body; tests drive it
        directly): snapshot + ring tail + store maintenance. Returns the
        number of samples appended."""
        t0 = time.perf_counter()
        ts_ms = int(time.time() * 1000) if ts_ms is None else ts_ms
        try:
            appended = self.db.append_snapshot(self._merged_snapshot(),
                                               ts_ms=ts_ms)
            new_traces, new_events, self._trace_cursor, \
                self._event_cursor = self._flight.tail(
                    self._trace_cursor, self._event_cursor)
            for t in new_traces:
                self.db.append_trace(t, ts_ms=ts_ms)
            for e in new_events:
                self.db.append_event(e, ts_ms=ts_ms)
            self.db.flush()
            if self.db.maybe_roll(now_ms=ts_ms):
                self._swept.inc(self.db.sweep(now_ms=ts_ms))
                folded = self.db.compact(now_ms=ts_ms)
                if folded:
                    self._compactions.inc(folded)
            self._samples.inc(appended)
            self._segments.set(float(len(self.db._sealed())))
            self._segment_bytes.set(float(self.db._active_bytes))
            self._scrapes.inc(status="ok")
            return appended
        except Exception:
            logger.exception("telemetry persistence tick failed")
            self._scrapes.inc(status="error")
            return 0
        finally:
            self._scrape_hist.observe(time.perf_counter() - t0)

    def _loop(self) -> None:
        from predictionio_tpu_torch.obs.tracing import carried

        while not self._stop.wait(self.cfg.interval_s):
            # a root per tick (record=False: background persistence must
            # not flood the very ring it persists) keeps any span()
            # below attributed instead of orphaned
            with carried(None, "telemetry_scrape", record=False):
                self.scrape_once()

    # -- lifecycle -----------------------------------------------------------
    def start(self, restore: bool = True) -> "TelemetryRecorder":
        if restore:
            try:
                restored = self.restore_recorder()
                if restored:
                    logger.info("telemetry restored %d flight-recorder "
                                "record(s) from %s", restored, self.db.dir)
            except Exception:
                logger.exception("flight-recorder restore failed")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"pio-telemetry-{self.service}")
        self._thread.start()
        logger.info("telemetry armed: %s every %.1fs (retention %.0fs)",
                    self.db.dir, self.cfg.interval_s, self.cfg.retention_s)
        return self

    def stop(self) -> None:
        """Graceful shutdown: stop the loop, then drain one final
        snapshot + the remaining ring records — completed traces and
        lifecycle events survive the process."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.scrape_once()
        self.db.close()


def build_recorder(service: str,
                   config: Optional[TelemetryConfig] = None,
                   registries: Optional[List[MetricsRegistry]] = None,
                   instance: Optional[str] = None
                   ) -> Optional[TelemetryRecorder]:
    """The run_* entry points' factory: a started recorder when the
    resolved config enables telemetry, else None. Never raises — a
    broken (or already-owned: tsdb.TSDBLocked) store must not stop a
    server from booting. ``instance`` distinguishes co-hosted processes
    of the same service (the entry points pass their port): stores are
    single-writer, and the key must also be STABLE across restarts or
    rehydration would read an empty store."""
    if config is None:
        from predictionio_tpu_torch.utils.server_config import telemetry_config

        config = telemetry_config()
    if not config.enabled:
        return None
    name = f"{service}-{instance}" if instance else service
    try:
        return TelemetryRecorder(name, config,
                                 registries=registries).start()
    except Exception:
        logger.exception("telemetry disabled: store open failed")
        return None


def history_reader_factory(telemetry: Optional[TelemetryRecorder] = None,
                           root: Optional[str] = None
                           ) -> Callable[[], TSDBReader]:
    """The reader the /history routes re-open per request: the fleet
    view over the telemetry root (every service's store, labeled per
    process). Without a recorder OR an explicit root, reads answer
    empty — a server with telemetry off still mounts the surface."""
    from predictionio_tpu_torch.obs import fleet

    if root is None and telemetry is not None:
        root = telemetry.cfg.root_dir()
    if root is None:
        return lambda: TSDBReader([])
    return lambda: fleet.history_reader(root)


# ---------------------------------------------------------------------------
# the /history HTTP surface (shared by all four servers)
# ---------------------------------------------------------------------------

def _parse_since_ms(query) -> Optional[int]:
    try:
        if "sinceS" in query:
            return int((time.time() - float(query["sinceS"])) * 1000)
        if "sinceMs" in query:
            return int(query["sinceMs"])
    except (TypeError, ValueError):
        pass
    return None


#: unauthenticated like METRICS_PATHS (aggregate counts only)
HISTORY_PATHS = ("/history/series.json", "/history/range.json")


def history_routes(reader_factory: Callable[[], TSDBReader]) -> list:
    """``GET /history/series.json`` + ``GET /history/range.json`` as
    ``server/http`` routes, rendering ``reader_factory()``'s stores
    (called per request: the directory listing IS the freshness
    contract, no caches to invalidate). Unauthenticated like /metrics:
    aggregate counts only."""
    import asyncio
    import json as _json

    async def _offloop(fn):
        # readers scan + CRC-check real segment files: synchronous by
        # nature, so the work runs off the event loop
        return await asyncio.get_running_loop().run_in_executor(None, fn)

    async def handle_series(req):
        name = req.query.get("name")
        since = _parse_since_ms(req.query)

        def _read():
            out = []
            for info in reader_factory().series(name=name, since_ms=since):
                if not info.points:
                    continue
                out.append({
                    "name": info.name, "labels": info.labels,
                    "kind": info.kind, "samples": len(info.points),
                    "firstMs": info.points[0][0],
                    "lastMs": info.points[-1][0]})
            return out

        return 200, {"series": await _offloop(_read)}

    async def handle_range(req):
        q = req.query
        name = q.get("name")
        if not name:
            return 400, {"message": "name parameter required"}
        labels = None
        if q.get("labels"):
            try:
                labels = _json.loads(q["labels"])
            except ValueError:
                labels = None
            if not isinstance(labels, dict):
                return 400, {"message": "labels must be a JSON object"}
        since = _parse_since_ms(q)
        if q.get("quantile"):
            try:
                quantile = float(q["quantile"])
            except ValueError:
                return 400, {"message": "quantile must be a number"}
            value = await _offloop(
                lambda: reader_factory().quantile_over_time(
                    name, quantile, labels=labels, since_ms=since))
            return 200, {"name": name, "quantile": quantile, "value": value}
        if q.get("rate"):
            series = await _offloop(
                lambda: reader_factory().rate(name, labels=labels,
                                              since_ms=since))
            return 200, {"name": name, "series": series}

        def _read():
            series = []
            for info in reader_factory().series(name=name, labels=labels,
                                                since_ms=since):
                if info.kind == "histogram":
                    points = [[ts, sum(counts), total]
                              for ts, counts, total in info.points]
                else:
                    points = [[ts, v] for ts, v in info.points]
                series.append({"labels": info.labels, "kind": info.kind,
                               "points": points})
            return series

        return 200, {"name": name, "series": await _offloop(_read)}

    return [("GET", "/history/series.json", handle_series),
            ("GET", "/history/range.json", handle_range)]
