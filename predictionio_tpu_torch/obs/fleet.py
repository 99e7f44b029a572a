"""Fleet metric aggregation: many processes, one merged view (the
reference's ``obs/fleet.py`` without its ``history_dirs`` /
``history_reader``, which read ``obs/tsdb`` stores, not ported yet).

* :func:`snapshot` exports a registry's raw state (plus the process's
  flight-recorder rings) as one JSON document;
* :func:`write_snapshot` / :func:`read_snapshot` move it between
  processes with the crash-safe temp-write + atomic-rename discipline
  the batchpredict fragments use;
* :class:`FleetView` merges any number of per-process snapshots into a
  single registry whose every sample carries a ``process`` label, with
  exact counter sums and exact histogram bucket merges
  (``MetricsRegistry.merge_snapshot``), plus the union of the
  processes' trace/lifecycle records.

Each batchpredict shard commits its obs snapshot BEFORE its done-marker
meta, and the last shard to finish merges the snapshots into
``<output>.fleet.json`` beside the merged predictions.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.obs.trace_context import recorder

SNAPSHOT_VERSION = 1

#: metric-name prefix exported into fleet snapshots — host-local python
#: details have no fleet meaning, the pio_* inventory does
SNAPSHOT_PREFIX = "pio_"


def snapshot(registry: MetricsRegistry,
             process: Optional[str] = None,
             extra: Optional[dict] = None,
             include_traces: bool = True) -> dict:
    """One process's observable state as a JSON-ready document."""
    metrics = {name: entry
               for name, entry in registry.to_snapshot().items()
               if name.startswith(SNAPSHOT_PREFIX)}
    doc = {
        "version": SNAPSHOT_VERSION,
        "process": process if process is not None else str(os.getpid()),
        "ts": time.time(),
        "metrics": metrics,
    }
    if include_traces:
        rings = recorder().to_json()
        doc["traces"] = rings["traces"]
        doc["events"] = rings["events"]
    if extra:
        doc.update(extra)
    return doc


def write_snapshot(path: str, doc: dict) -> None:
    """Commit a snapshot file atomically (temp-write + rename): a reader
    can never observe a torn document."""
    tmp = f"{path}.tmp-{uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
    os.replace(tmp, path)


def read_snapshot(path: str) -> Optional[dict]:
    """A committed snapshot, or None when missing/torn."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "metrics" not in doc:
        return None
    return doc


class FleetView:
    """Per-process snapshots merged into one registry + one recorder.

    Every merged sample gains a ``process`` label; counter totals across
    the fleet are exact sums of the per-shard counters (asserted in
    tests), histogram merges are exact per-bucket adds."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.processes: List[str] = []
        self._traces: List[dict] = []
        self._events: List[dict] = []
        self._seen_spans: set = set()

    def add(self, doc: dict, process: Optional[str] = None) -> None:
        proc = str(process if process is not None
                   else doc.get("process", len(self.processes)))
        self.processes.append(proc)
        self.registry.merge_snapshot(doc.get("metrics", {}),
                                     extra_labels={"process": proc})
        for t in doc.get("traces", ()):
            # dedupe by span identity: shards sharing a recorder (tests
            # running a fleet in one process) export overlapping rings
            key = (t.get("traceId"), t.get("spanId"), t.get("name"))
            if t.get("spanId") and key in self._seen_spans:
                continue
            self._seen_spans.add(key)
            entry = dict(t)
            entry.setdefault("process", proc)
            self._traces.append(entry)
        for e in doc.get("events", ()):
            entry = dict(e)
            entry.setdefault("process", proc)
            self._events.append(entry)

    # -- readout -------------------------------------------------------------
    def counter_total(self, name: str, **labels) -> float:
        """The fleet-wide sum of a counter across every process (the
        given labels are the metric's own, without ``process``)."""
        metric = self.registry.get(name)
        if metric is None:
            return 0.0
        want = {k: str(v) for k, v in labels.items()}
        total = 0.0
        for sample_labels, value in metric.samples():
            rest = {k: v for k, v in sample_labels.items()
                    if k != "process"}
            if all(rest.get(k) == v for k, v in want.items()):
                total += value
        return total

    def counter_totals(self) -> Dict[str, float]:
        """Fleet-wide grand total per counter name (all labels summed)."""
        out: Dict[str, float] = {}
        for metric in self.registry.collect():
            if metric.kind != "counter":
                continue
            out[metric.name] = sum(v for _, v in metric.samples())
        return out

    def traces(self, trace_id: Optional[str] = None) -> List[dict]:
        if trace_id is None:
            return list(self._traces)
        return [t for t in self._traces if t.get("traceId") == trace_id]

    def events(self) -> List[dict]:
        return list(self._events)

    def trace_ids(self) -> List[str]:
        seen, out = set(), []
        for t in self._traces:
            tid = t.get("traceId")
            if tid and tid not in seen:
                seen.add(tid)
                out.append(tid)
        return out

    def to_json(self) -> dict:
        return {
            "version": SNAPSHOT_VERSION,
            "processes": list(self.processes),
            "metrics": self.registry.render_json(),
            "counterTotals": self.counter_totals(),
            "traces": self._traces,
            "events": self._events,
        }

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()


def merge_snapshot_files(paths: List[str]) -> FleetView:
    """Build a FleetView from committed snapshot files; a missing or torn
    file is skipped (the caller decides whether partial fleets are ok)."""
    view = FleetView()
    for path in paths:
        doc = read_snapshot(path)
        if doc is not None:
            view.add(doc)
    return view


def import_into_recorder(view: FleetView) -> None:
    """Fold a fleet view's trace/lifecycle records into THIS process's
    flight recorder, so /debug/traces.json on the merger shows the whole
    fleet's spans under one trace id."""
    recorder().import_records(view.traces(), view.events())
