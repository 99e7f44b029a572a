"""Event-server ingest statistics.

Parity with the reference's Stats/StatsActor
(data/.../api/Stats.scala:28-80, StatsActor.scala:30-76): per-app counters
keyed by (status, event name, entity type), kept for the current hour and
for the server's lifetime, surfaced at /stats.json.

The lifetime ("longLive") counts are backed by the obs metrics registry
(``pio_event_bookkeeping_total``), so the same numbers appear at
``/metrics`` and ``/stats.json`` without double accounting.  The hourly
window stays a plain dict because Prometheus counters are monotonic and
cannot roll; on a window roll the previous hour is preserved and exposed
as the additive ``prevHourly`` key (the reference silently dropped it).
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import Counter
from typing import Dict, Optional

from predictionio_tpu_torch.data.event import UTC, Event
from predictionio_tpu_torch.obs.registry import MetricsRegistry, default_registry

#: event/entity-type label values are client-supplied; past this many
#: distinct series new combos collapse into "__other__" so an adversarial
#: key holder cannot grow the (unauthenticated) /metrics exposition
#: without bound
MAX_BOOKKEEPING_SERIES = 1000


class Stats:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._hour_start = self._floor_hour(_dt.datetime.now(tz=UTC))
        self._hourly: Dict[int, Counter] = {}
        self._prev_hourly: Dict[int, Counter] = {}
        self.registry = registry or default_registry()
        self._longlive = self.registry.counter(
            "pio_event_bookkeeping_total",
            "Lifetime ingest bookkeeping by app/status/event/entity type",
            labelnames=("app_id", "status", "event", "entity_type"))

    @staticmethod
    def _floor_hour(t: _dt.datetime) -> _dt.datetime:
        return t.replace(minute=0, second=0, microsecond=0)

    def bookkeeping(self, app_id: int, status: int, event: Event) -> None:
        key = (status, event.event, event.entity_type)
        now = _dt.datetime.now(tz=UTC)
        with self._lock:
            hour = self._floor_hour(now)
            if hour != self._hour_start:  # roll the hourly window
                # "previous hour" only means the immediately preceding one;
                # after an idle gap the old window is stale, not previous
                contiguous = hour == self._hour_start + _dt.timedelta(hours=1)
                self._prev_hourly = self._hourly if contiguous else {}
                self._hour_start = hour
                self._hourly = {}
            self._hourly.setdefault(app_id, Counter())[key] += 1
        labels = dict(app_id=str(app_id), status=str(status),
                      event=event.event,
                      entity_type=event.entity_type or "")
        if (not self._longlive.contains(**labels)
                and self._longlive.series_count() >= MAX_BOOKKEEPING_SERIES):
            labels["event"] = "__other__"
            labels["entity_type"] = "__other__"
        self._longlive.inc(**labels)

    def _longlive_counter(self, app_id: int) -> Counter:
        app = str(app_id)
        out: Counter = Counter()
        for labels, value in self._longlive.samples():
            if labels["app_id"] != app:
                continue
            key = (int(labels["status"]), labels["event"],
                   labels["entity_type"])
            out[key] += int(value)
        return out

    def get(self, app_id: int) -> dict:
        with self._lock:
            # snapshot under the lock: a concurrent bookkeeping() may
            # mutate these Counters mid-render otherwise
            hourly = Counter(self._hourly.get(app_id, Counter()))
            prev = Counter(self._prev_hourly.get(app_id, Counter()))
            start = self._hour_start
        return {
            "startTime": start.isoformat(),
            "hourly": _render(hourly),
            "longLive": _render(self._longlive_counter(app_id)),
            "prevHourly": _render(prev),
        }


def _render(counter: Counter) -> list:
    return [
        {"status": status, "event": event, "entityType": etype, "count": count}
        for (status, event, etype), count in sorted(counter.items())
    ]
