"""Process-wide metrics registry with Prometheus text exposition (a copy
of the reference's ``obs/registry.py``: the same series, the same text,
the same JSON and snapshots, so fleet merges and scrapers read either
package's output alike).

Three metric kinds, all label-aware and thread-safe:

  * :class:`Counter`   — monotonically increasing totals
  * :class:`Gauge`     — point-in-time values, optionally callback-backed
                         (evaluated lazily at scrape time)
  * :class:`Histogram` — bucketed observations with exponential latency
                         buckets by default, p50/p95/p99 estimation and
                         per-bucket exemplars (the trace id of the newest
                         observation that landed there)

A :class:`MetricsRegistry` owns metrics by name (get-or-create) and
renders them as Prometheus text exposition format 0.0.4 or as JSON;
``to_snapshot``/``merge_snapshot`` move a registry's raw state between
processes (``obs/fleet``). Workflow metrics live on the process-global
``default_registry()``.

Dependency-free: nothing here imports torch or a server.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: 0.5 ms .. ~16 s, doubling
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    0.0005 * 2.0 ** i for i in range(16))

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: per-metric label-series cap: past it, NEW label combinations collapse
#: into values "other" and pio_obs_label_overflow_total{metric} counts
#: the overflow — a per-entity or per-query label can never grow the
#: unauthenticated /metrics exposition without bound. Above the event
#: server's own 1000-series bookkeeping cap so that guard fires first.
DEFAULT_MAX_SERIES = 2048

OVERFLOW_COUNTER = "pio_obs_label_overflow_total"
#: the label value overflowing combinations collapse into
OVERFLOW_LABEL_VALUE = "other"

#: exemplar source consulted by Histogram.observe — returns the active
#: trace id, or None when no request context is live. Installed with
#: :func:`set_exemplar_provider` (a late hook keeps this module
#: dependency-free: registry cannot import tracing, which imports it).
_exemplar_provider: Optional[Callable[[], Optional[str]]] = None

#: one exemplar is (trace_id, observed value, unix ts) — newest wins
Exemplar = Tuple[str, float, float]


def set_exemplar_provider(
        fn: Optional[Callable[[], Optional[str]]]) -> None:
    """Install (or clear, with None) the process-wide exemplar source."""
    global _exemplar_provider
    _exemplar_provider = fn


def exponential_buckets(start: float, factor: float, count: int
                        ) -> Tuple[float, ...]:
    """`count` bucket upper bounds growing geometrically from `start`."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _format_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                   extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, labelvalues)]
    pairs.extend(extra)
    if not pairs:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(str(v))}"' for n, v in pairs)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        #: label-cardinality guard (see DEFAULT_MAX_SERIES); the owning
        #: registry sets the backpointer so overflow can be counted
        self.max_series = DEFAULT_MAX_SERIES
        self._registry: Optional["MetricsRegistry"] = None
        self._overflow_key = tuple(
            OVERFLOW_LABEL_VALUE for _ in self.labelnames)

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _guarded_key(self, key: Tuple[str, ...], store: Dict) -> Tuple:
        """Called UNDER self._lock: the key to actually account against —
        a new combination past the cap collapses into the overflow
        bucket. Returns (key, overflowed)."""
        if (self.labelnames and key not in store
                and len(store) >= self.max_series):
            return self._overflow_key, True
        return key, False

    def _note_overflow(self) -> None:
        """Called OUTSIDE self._lock (the overflow counter takes its own
        lock; never hold two metric locks at once)."""
        reg = self._registry
        if reg is not None:
            reg._overflow_counter().inc(metric=self.name)

    def signature(self) -> Tuple[str, Tuple[str, ...]]:
        return (self.kind, self.labelnames)

    # subclasses implement: samples(), render(lines)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            key, overflowed = self._guarded_key(key, self._values)
            self._values[key] = self._values.get(key, 0.0) + amount
        if overflowed:
            self._note_overflow()

    def to_snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "series": [{"labels": labels, "value": value}
                           for labels, value in self.samples()]}

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def contains(self, **labels) -> bool:
        key = self._key(labels)
        with self._lock:
            return key in self._values

    def series_count(self) -> int:
        with self._lock:
            return len(self._values)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = sorted(self._values.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]

    def render(self, lines: List[str]) -> None:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for key, value in items:
            lines.append(self.name
                         + _format_labels(self.labelnames, key)
                         + " " + _format_value(value))


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._fn: Optional[Callable] = None

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            key, overflowed = self._guarded_key(key, self._values)
            self._values[key] = float(value)
        if overflowed:
            self._note_overflow()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            key, overflowed = self._guarded_key(key, self._values)
            self._values[key] = self._values.get(key, 0.0) + amount
        if overflowed:
            self._note_overflow()

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def to_snapshot(self) -> dict:
        """Callback gauges are evaluated here — a snapshot carries the
        values a scrape would have seen at this moment."""
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "series": [{"labels": labels, "value": value}
                           for labels, value in self.samples()]}

    def set_function(self, fn: Callable) -> None:
        """Lazy gauge: `fn()` is evaluated at scrape time and must return
        a number, or an iterable of (labels_dict, number) when the gauge
        has labelnames."""
        self._fn = fn

    def value(self, **labels) -> float:
        for sample_labels, v in self.samples():
            if sample_labels == {k: str(v_) for k, v_ in labels.items()}:
                return v
        return 0.0

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        fn = self._fn
        if fn is not None:
            try:
                out = fn()
            except Exception:
                return []
            if isinstance(out, (int, float)):
                return [({}, float(out))]
            return [(dict(labels), float(v)) for labels, v in out]
        with self._lock:
            items = sorted(self._values.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]

    def render(self, lines: List[str]) -> None:
        samples = self.samples()
        if not samples and not self.labelnames and self._fn is None:
            samples = [({}, 0.0)]
        for labels, value in samples:
            names = tuple(labels)
            values = tuple(labels[n] for n in names)
            lines.append(self.name + _format_labels(names, values)
                         + " " + _format_value(value))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        finite = sorted({float(b) for b in buckets if b != math.inf})
        if not finite:
            raise ValueError("histogram needs at least one finite bucket")
        self.buckets = tuple(finite)  # +Inf is implicit
        #: key -> [per-bucket counts..., +Inf count] plus running sum
        self._counts: Dict[Tuple[str, ...], List[float]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        #: key -> per-bucket exemplar slots (same layout as counts, one
        #: slot per bucket plus +Inf); newest observation with a live
        #: trace id wins its slot. Bounded by construction: at most
        #: (buckets+1) tuples per live series.
        self._exemplars: Dict[Tuple[str, ...],
                              List[Optional[Exemplar]]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        tid = None
        provider = _exemplar_provider
        if provider is not None:
            try:
                tid = provider()
            except Exception:
                tid = None
        with self._lock:
            key, overflowed = self._guarded_key(key, self._counts)
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0.0] * (len(self.buckets) + 1)
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            if tid is not None:
                slots = self._exemplars.get(key)
                if slots is None:
                    slots = self._exemplars[key] = \
                        [None] * (len(self.buckets) + 1)
                slots[idx] = (tid, value, time.time())
        if overflowed:
            self._note_overflow()

    def count_below(self, threshold: float, **labels) -> float:
        """Observations <= the bucket bound holding `threshold` (the
        exact count when `threshold` IS a bucket bound — SLO latency
        thresholds should be chosen on bucket edges; otherwise the count
        is for the next bound above). No labels = summed over keys."""
        idx = bisect.bisect_left(self.buckets, threshold)
        if labels:
            keys = [self._key(labels)]
        else:
            with self._lock:
                keys = list(self._counts)
        total = 0.0
        with self._lock:
            for key in keys:
                counts = self._counts.get(key, ())
                total += sum(counts[:idx + 1])
        return total

    def to_snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            exemplars = {k: list(v) for k, v in self._exemplars.items()}
        series = []
        for key, counts in items:
            s = {"labels": dict(zip(self.labelnames, key)),
                 "counts": list(counts),
                 "sum": sums.get(key, 0.0)}
            slots = exemplars.get(key)
            if slots and any(e is not None for e in slots):
                s["exemplars"] = [list(e) if e is not None else None
                                  for e in slots]
            series.append(s)
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "buckets": list(self.buckets),
                "series": series}

    def _merge_series(self, labels: Dict[str, str], counts: Sequence[float],
                      sum_: float,
                      exemplars: Optional[Sequence] = None) -> None:
        """Elementwise-add raw per-bucket counts (fleet merge). The
        caller has verified bucket-bound equality; count vectors are the
        raw per-bucket layout to_snapshot exports. Exemplar slots merge
        newest-per-bucket by timestamp (exemplars are evidence pointers,
        not additive samples)."""
        key = self._key(labels)
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"{self.name}: snapshot has {len(counts)} buckets, "
                f"this histogram has {len(self.buckets) + 1}")
        if exemplars is not None and len(exemplars) != len(counts):
            raise ValueError(
                f"{self.name}: snapshot has {len(exemplars)} exemplar "
                f"slots for {len(counts)} buckets")
        with self._lock:
            key, overflowed = self._guarded_key(key, self._counts)
            mine = self._counts.get(key)
            if mine is None:
                mine = self._counts[key] = [0.0] * (len(self.buckets) + 1)
            for i, c in enumerate(counts):
                mine[i] += c
            self._sums[key] = self._sums.get(key, 0.0) + sum_
            if exemplars is not None:
                slots = self._exemplars.get(key)
                if slots is None:
                    slots = self._exemplars[key] = \
                        [None] * (len(self.buckets) + 1)
                for i, ex in enumerate(exemplars):
                    if ex is None:
                        continue
                    ex = (str(ex[0]), float(ex[1]), float(ex[2]))
                    if slots[i] is None or ex[2] >= slots[i][2]:
                        slots[i] = ex
        if overflowed:
            self._note_overflow()

    # -- exemplars (SLO evidence + exposition read these) --------------------
    def exemplars(self, **labels) -> List[Optional[Exemplar]]:
        """Per-bucket exemplar slots ([+Inf] last), None where no
        exemplar has landed. No labels = newest-per-bucket merged across
        every series."""
        if labels:
            key = self._key(labels)
            with self._lock:
                slots = self._exemplars.get(key)
                return (list(slots) if slots
                        else [None] * (len(self.buckets) + 1))
        merged: List[Optional[Exemplar]] = \
            [None] * (len(self.buckets) + 1)
        with self._lock:
            for slots in self._exemplars.values():
                for i, ex in enumerate(slots):
                    if ex is not None and (merged[i] is None
                                           or ex[2] >= merged[i][2]):
                        merged[i] = ex
        return merged

    def exemplars_above(self, threshold: float) -> List[Exemplar]:
        """Exemplars from the buckets at/above `threshold`, filtered to
        observed values strictly above it, newest first — the 'show me a
        trace that burned the budget' query SLO breach evidence uses."""
        idx = bisect.bisect_left(self.buckets, threshold)
        out = [ex for ex in self.exemplars()[idx:]
               if ex is not None and ex[1] > threshold]
        out.sort(key=lambda ex: ex[2], reverse=True)
        return out

    # -- accessors (serving-stats endpoints read these) ----------------------
    def count(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(sum(self._counts.get(key, ())))

    def total_count(self) -> float:
        with self._lock:
            return float(sum(sum(c) for c in self._counts.values()))

    def sum_(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._sums.get(key, 0.0)

    def total_sum(self) -> float:
        with self._lock:
            return float(sum(self._sums.values()))

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile (0 < q < 1) by linear interpolation
        within the bucket that holds the target rank; observations beyond
        the last finite bucket clamp to its upper bound (same convention
        as Prometheus `histogram_quantile`)."""
        if labels:
            keys = [self._key(labels)]
        else:
            with self._lock:
                keys = list(self._counts)
        with self._lock:
            merged = [0.0] * (len(self.buckets) + 1)
            for key in keys:
                for i, c in enumerate(self._counts.get(key, ())):
                    merged[i] += c
        total = sum(merged)
        if total == 0:
            return 0.0
        target = q * total
        cumulative = 0.0
        for i, c in enumerate(merged):
            if cumulative + c >= target and c > 0:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lower = self.buckets[i - 1] if i > 0 else 0.0
                upper = self.buckets[i]
                return lower + (upper - lower) * (target - cumulative) / c
            cumulative += c
        return self.buckets[-1]

    def samples(self) -> List[Tuple[Dict[str, str], Dict[str, float]]]:
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        out = []
        for key, counts in items:
            labels = dict(zip(self.labelnames, key))
            total = sum(counts)
            buckets, cum = {}, 0.0
            for le, c in zip(self.buckets, counts):
                cum += c
                buckets[_format_value(le)] = cum
            buckets["+Inf"] = total
            out.append((labels, {
                "count": total, "sum": sums.get(key, 0.0),
                "buckets": buckets}))
        return out

    def render(self, lines: List[str]) -> None:
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            exemplars = {k: list(v) for k, v in self._exemplars.items()}
        for key, counts in items:
            cumulative = 0.0
            for le, c in zip(self.buckets, counts):
                cumulative += c
                lines.append(
                    self.name + "_bucket"
                    + _format_labels(self.labelnames, key,
                                     extra=(("le", _format_value(le)),))
                    + " " + _format_value(cumulative))
            lines.append(
                self.name + "_bucket"
                + _format_labels(self.labelnames, key, extra=(("le", "+Inf"),))
                + " " + _format_value(sum(counts)))
            lines.append(self.name + "_sum"
                         + _format_labels(self.labelnames, key)
                         + " " + _format_value(sums.get(key, 0.0)))
            lines.append(self.name + "_count"
                         + _format_labels(self.labelnames, key)
                         + " " + _format_value(sum(counts)))
            # exemplars ride as comment lines so 0.0.4 text parsers (and
            # the reference's parse_exposition) stay compatible; scrapers
            # that understand them match on the "# exemplar " prefix
            slots = exemplars.get(key)
            if slots:
                bounds = [_format_value(b) for b in self.buckets] + ["+Inf"]
                for le, ex in zip(bounds, slots):
                    if ex is None:
                        continue
                    lines.append(
                        "# exemplar " + self.name + "_bucket"
                        + _format_labels(self.labelnames, key,
                                         extra=(("le", le),))
                        + f' trace_id="{_escape_label_value(ex[0])}" '
                        + _format_value(ex[1]) + " " + _format_value(ex[2]))


class MetricsRegistry:
    """Named metrics, get-or-create, rendered in registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames,
                       max_series=None, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is not None:
                if metric.signature() != (cls.kind, tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{metric.signature()}, requested "
                        f"{(cls.kind, tuple(labelnames))}")
                if max_series is not None:
                    metric.max_series = max_series
                return metric
            metric = cls(name, help, labelnames, **kwargs)
            metric._registry = self
            if max_series is not None:
                metric.max_series = max_series
            self._metrics[name] = metric
            return metric

    def _overflow_counter(self) -> Counter:
        """The per-metric label-overflow counter (lazily registered so an
        untouched registry renders exactly what its callers created).
        Effectively exempt from its own guard: metric names are
        code-defined and bounded."""
        return self._get_or_create(
            Counter, OVERFLOW_COUNTER,
            "Label combinations collapsed into the 'other' bucket by the "
            "per-metric series cap", ("metric",), max_series=1 << 31)

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                max_series: Optional[int] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames,
                                   max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              max_series: Optional[int] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames,
                                   max_series=max_series)

    def gauge_callback(self, name: str, help: str, fn: Callable,
                       labelnames: Sequence[str] = ()) -> Gauge:
        """Register (or re-point, idempotently) a scrape-time callback gauge."""
        gauge = self._get_or_create(Gauge, name, help, labelnames)
        gauge.set_function(fn)
        return gauge

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  max_series: Optional[int] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   max_series=max_series, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def render_prometheus(self) -> str:
        return render_prometheus([self])

    def render_json(self) -> dict:
        out = {}
        for metric in self.collect():
            entry = {"kind": metric.kind, "help": metric.help}
            if isinstance(metric, Histogram):
                entry["samples"] = [
                    {"labels": labels, "count": s["count"], "sum": s["sum"],
                     "avg": (s["sum"] / s["count"]) if s["count"] else 0.0,
                     "buckets": s["buckets"]}
                    for labels, s in metric.samples()]
                entry["p50"] = metric.quantile(0.50)
                entry["p95"] = metric.quantile(0.95)
                entry["p99"] = metric.quantile(0.99)
                bounds = ([_format_value(b) for b in metric.buckets]
                          + ["+Inf"])
                ex = [{"le": le, "traceId": e[0], "value": e[1],
                       "ts": e[2]}
                      for le, e in zip(bounds, metric.exemplars())
                      if e is not None]
                if ex:
                    entry["exemplars"] = ex
            else:
                entry["samples"] = [
                    {"labels": labels, "value": value}
                    for labels, value in metric.samples()]
            out[metric.name] = entry
        return out

    # -- fleet aggregation (obs/fleet.py rides these) ------------------------
    def to_snapshot(self) -> dict:
        """JSON-ready export of every metric's raw state (histograms as
        raw per-bucket counts, so a merge is exact — not a quantile
        estimate of an estimate). Callback gauges are evaluated."""
        return {m.name: m.to_snapshot() for m in self.collect()}

    def merge_snapshot(self, snap: dict,
                       extra_labels: Optional[Dict[str, str]] = None
                       ) -> None:
        """Fold another process's :meth:`to_snapshot` export into this
        registry, get-or-creating each metric with the snapshot's
        labelnames extended by ``extra_labels`` (fleet views add
        ``process``). Counters and histograms ADD (merge is associative
        and commutative, merge-with-empty is the identity — tested);
        gauges SET per extended key (point-in-time values: with a
        distinct ``process`` label per source the keys are disjoint).
        A histogram whose bucket bounds disagree with an
        already-registered one raises — silently re-bucketing would
        corrupt quantiles."""
        extra = dict(extra_labels or {})
        for name, entry in snap.items():
            kind = entry.get("kind")
            labelnames = tuple(entry.get("labelnames", ())) + tuple(extra)
            if kind == "counter":
                m = self.counter(name, entry.get("help", ""), labelnames)
                for s in entry.get("series", ()):
                    m.inc(s["value"], **{**s["labels"], **extra})
            elif kind == "gauge":
                m = self.gauge(name, entry.get("help", ""), labelnames)
                for s in entry.get("series", ()):
                    labels = {**s["labels"], **extra}
                    if set(labels) != set(labelnames):
                        continue   # callback gauge with ad-hoc labels
                    m.set(s["value"], **labels)
            elif kind == "histogram":
                buckets = tuple(entry.get("buckets", ()))
                m = self.histogram(name, entry.get("help", ""), labelnames,
                                   buckets=buckets or
                                   DEFAULT_LATENCY_BUCKETS)
                if tuple(m.buckets) != buckets:
                    raise ValueError(
                        f"histogram {name!r}: snapshot buckets "
                        f"{buckets} != registered {m.buckets}")
                for s in entry.get("series", ()):
                    m._merge_series({**s["labels"], **extra},
                                    s["counts"], s.get("sum", 0.0),
                                    s.get("exemplars"))


def render_prometheus(registries: Iterable[MetricsRegistry]) -> str:
    """Merge several registries into one exposition; the first registry
    to define a metric name wins (server-local metrics shadow globals)."""
    lines: List[str] = []
    seen = set()
    for registry in registries:
        for metric in registry.collect():
            if metric.name in seen:
                continue
            seen.add(metric.name)
            if metric.help:
                lines.append(f"# HELP {metric.name} "
                             f"{_escape_help(metric.help)}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            metric.render(lines)
    return "\n".join(lines) + "\n"


def render_json(registries: Iterable[MetricsRegistry]) -> dict:
    merged: dict = {}
    for registry in registries:
        for name, entry in registry.render_json().items():
            merged.setdefault(name, entry)
    return merged


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry (workflow + device metrics live here;
    servers merge it into their /metrics exposition)."""
    return _default_registry
