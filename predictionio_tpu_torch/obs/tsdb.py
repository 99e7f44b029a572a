"""Embedded, append-only, crash-safe time-series store (the reference's
``obs/tsdb.py``; the on-disk format is the reference's, so a store
either package writes is read by the other with the same answers).

Metrics, SLO burn windows and flight-recorder rings live in process
memory and die with the process. This module is the durable substrate
under them: a dependency-free local store the telemetry loop
(obs/telemetry.py) appends each process's registry snapshot into, and
everything longitudinal (`/history/*.json`, `pio metrics query`, SLO
rehydration, the canary splitter's restore) reads back out.

**File format.** A store is a directory of segment files. One ACTIVE
segment (``active-<id>.tlog``) takes appends; sealed segments
(``seg-<id>.tlog``) are immutable. Every record is length-prefixed and
checksummed::

    <u32 payload length> <u32 crc32(payload)> <payload: compact JSON>

so a reader only ever consumes WHOLE records: a torn tail (kill mid
append, torn page on crash) fails the length/crc check and parsing
stops there — a concurrent reader can never observe half a record, and
recovery truncates the active segment at the last whole record.

Record kinds (the ``k`` field): ``seg`` (segment meta, carries the
``replaces`` list compaction uses), ``series`` (series dictionary:
id → metric name + labels + kind + buckets), ``s`` (scalar sample),
``h`` (histogram sample: per-bucket cumulative counts + sum), ``e``
(flight-recorder lifecycle event), ``tr`` (flight-recorder trace).
Samples are DELTA-ENCODED per series against the previous sample in
the same segment (cumulative counters mostly append tiny deltas; the
first sample of a series in each segment is absolute), so every
segment is self-contained — a reader needs no other file to decode it.

**Commit discipline**: appends go through ONE
helper (:meth:`TSDB._append_payload` — the checksummed-append
discipline), and every multi-record rewrite — sealing a segment on
roll, merging segments on compaction — is temp-write + ``os.replace``
through :meth:`TSDB._commit_file`. A compacted segment's meta record
names the input segments it ``replaces``; recovery (and readers) drop
replaced segments, so a kill between the compaction commit and the
input unlink duplicates nothing.

The record framing and the committed-rewrite primitive are the shared
log-structured substrate (``storage/logstore.py`` — the same machinery
under parquet compaction manifests and partitioned-store reshards);
this module re-exports ``pack_record``/``iter_record_payloads``/
``scan_records`` for its readers and keeps the tsdb-specific pieces
(segment naming, the WRITER claim, delta encoding, kill points) here.

**Concurrency.** One writer per directory — the telemetry recorder
thread owns all mutation (no internal locks: a lock held across file
I/O would stall every reader of the obs plane). Readers
(:class:`TSDBReader`) share nothing with the writer: they list the
directory and parse whole records, so they are safe from any process
at any time, including mid-append and mid-compaction.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.storage import logstore
from predictionio_tpu_torch.storage.faults import maybe_kill
from predictionio_tpu_torch.storage.logstore import (   # noqa: F401 — public API
    MAX_RECORD_BYTES, iter_record_payloads, pack_record, scan_records,
)

ACTIVE_PREFIX = "active-"
SEALED_PREFIX = "seg-"
SEGMENT_SUFFIX = ".tlog"


class TSDBLocked(Exception):
    """The directory is owned by another LIVE writer process."""

DEFAULT_RETENTION_S = 7 * 86400.0
DEFAULT_SEGMENT_MAX_BYTES = 4 << 20
DEFAULT_SEGMENT_MAX_AGE_S = 3600.0
#: compaction folds sealed segments once this many have accumulated
DEFAULT_COMPACT_MIN_SEGMENTS = 4


def _segment_id(name: str) -> str:
    for prefix in (ACTIVE_PREFIX, SEALED_PREFIX):
        if name.startswith(prefix) and name.endswith(SEGMENT_SUFFIX):
            return name[len(prefix):-len(SEGMENT_SUFFIX)]
    return ""


def list_segments(dirpath: str) -> List[str]:
    """Segment file names (sealed then active), id-ordered. Ids are
    zero-padded millisecond timestamps so lexical order is time order."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    segs = [n for n in names if _segment_id(n)]
    return sorted(segs, key=lambda n: (_segment_id(n),
                                       n.startswith(ACTIVE_PREFIX)))


@dataclasses.dataclass
class SeriesInfo:
    """One persisted series: the registry identity plus its points."""

    name: str
    labels: Dict[str, str]
    kind: str                      # counter | gauge | histogram
    buckets: Tuple[float, ...] = ()
    #: scalar kinds: [(ts_ms, value)]; histograms: [(ts_ms, counts, sum)]
    points: List[tuple] = dataclasses.field(default_factory=list)
    #: histogram exemplars, one slot per bucket (+Inf last): None or
    #: [trace_id, value, unix_ts] — newest-per-bucket across the series'
    #: whole recorded history (exemplars are evidence pointers, not
    #: samples, so they merge by recency instead of accumulating)
    exemplars: List[Optional[list]] = dataclasses.field(
        default_factory=list)

    def key(self) -> tuple:
        return (self.name, tuple(sorted(self.labels.items())),
                self.kind, self.buckets)


def merge_exemplar_slots(dst: List[Optional[list]],
                         src) -> List[Optional[list]]:
    """Newest-per-bucket merge of exemplar slot lists (the same algebra
    the registry's ``merge_snapshot`` uses; slot-count mismatches keep
    ``dst`` — persisted data is never worth raising over)."""
    if not src:
        return dst
    src = [list(e) if e else None for e in src]
    if not dst:
        return src
    if len(dst) != len(src):
        return dst
    for i, e in enumerate(src):
        if e is not None and (dst[i] is None or
                              float(e[2]) >= float(dst[i][2])):
            dst[i] = e
    return dst


class TSDB:
    """The single-writer store handle (see module docstring).

    Not thread-safe by design: exactly one thread (the telemetry
    recorder's) may call the mutating methods of one instance. Readers
    use :class:`TSDBReader`, which never touches writer state.
    """

    def __init__(self, dirpath: str,
                 retention_s: float = DEFAULT_RETENTION_S,
                 segment_max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES,
                 segment_max_age_s: float = DEFAULT_SEGMENT_MAX_AGE_S,
                 compact_min_segments: int = DEFAULT_COMPACT_MIN_SEGMENTS):
        self.dir = dirpath
        self.retention_s = float(retention_s)
        self.segment_max_bytes = int(segment_max_bytes)
        self.segment_max_age_s = float(segment_max_age_s)
        self.compact_min_segments = max(2, int(compact_min_segments))
        os.makedirs(dirpath, exist_ok=True)
        self._claim_dir()
        self._f = None                     # active segment handle
        self._active_name: Optional[str] = None
        self._active_bytes = 0
        self._active_started_ms = 0
        self._seq = 0                      # per-open id uniquifier
        #: series identity -> integer id (stable for this writer's life)
        self._sids: Dict[tuple, int] = {}
        self._defs: Dict[int, dict] = {}   # sid -> series record body
        self._emitted: set = set()         # sids defined in THIS segment
        self._last: Dict[int, object] = {}  # delta-encoding baselines
        #: last exemplar slots written per sid (unchanged slots are not
        #: re-appended — exemplars churn far slower than counts)
        self._last_ex: Dict[int, list] = {}
        self.recover()

    # -- the single-writer claim ---------------------------------------------
    def _claim_dir(self) -> None:
        """Enforce the one-writer-per-directory contract: the directory
        carries a WRITER file naming the owning pid. A LIVE foreign pid
        refuses the open (recovering over a live writer would truncate
        its active segment and unlink its temp files — silent data
        loss); a dead pid's claim is stale (SIGKILL leaves it) and is
        taken over; re-opening from the OWN pid (tests simulating
        restarts) passes."""
        path = os.path.join(self.dir, "WRITER")
        try:
            with open(path) as f:
                pid = int(f.read().strip() or 0)
        except (OSError, ValueError):
            pid = 0
        if pid and pid != os.getpid():
            try:
                os.kill(pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False               # stale claim: owner is dead
            except OSError:
                # PermissionError and friends mean the pid EXISTS (it
                # just isn't ours to signal) — taking over a live
                # other-user writer is exactly the data loss this
                # claim prevents
                alive = True
            if alive:
                raise TSDBLocked(
                    f"{self.dir} is owned by live writer pid {pid}; "
                    "telemetry stores are single-writer — give this "
                    "process its own store (PIO_TELEMETRY_DIR or a "
                    "distinct service instance)")
        self._commit_file("WRITER", None,
                          raw=f"{os.getpid()}\n".encode())

    # -- recovery ------------------------------------------------------------
    def recover(self) -> None:
        """Converge the directory after any crash: drop writer temp
        files, resolve half-done rolls/compactions, truncate the torn
        tail of the active segment, then seal it — a fresh process
        always starts a fresh segment (absolute re-baselined samples),
        so recovery never needs to reconstruct delta state."""
        names = os.listdir(self.dir)
        for n in names:
            if ".tmp-" in n:               # single writer per dir: any
                self._unlink(n)            # temp file is a dead writer's
        names = [n for n in os.listdir(self.dir) if _segment_id(n)]
        sealed_ids = {_segment_id(n) for n in names
                      if n.startswith(SEALED_PREFIX)}
        # a roll that committed but died before unlinking its source
        for n in list(names):
            if n.startswith(ACTIVE_PREFIX) and _segment_id(n) in sealed_ids:
                self._unlink(n)
                names.remove(n)
        # compaction outputs name the inputs they replace
        replaced: set = set()
        for n in names:
            if not n.startswith(SEALED_PREFIX):
                continue
            records, _ = scan_records(os.path.join(self.dir, n))
            if records and records[0].get("k") == "seg":
                replaced.update(records[0].get("replaces") or ())
        for n in list(names):
            if _segment_id(n) in replaced:
                self._unlink(n)
                names.remove(n)
        # truncate + seal every leftover active segment
        for n in sorted(n for n in names if n.startswith(ACTIVE_PREFIX)):
            path = os.path.join(self.dir, n)
            records, clean = scan_records(path)
            if clean < os.path.getsize(path):
                os.truncate(path, clean)
            if records:
                self._seal(n, records)
            else:
                self._unlink(n)

    def _unlink(self, name: str) -> None:
        try:
            os.unlink(os.path.join(self.dir, name))
        except OSError:
            pass

    # -- the two committed-write helpers ---------------------------------------
    def _append_payload(self, doc: dict) -> None:
        """THE append path: one length-prefixed, checksummed record onto
        the active segment. A kill mid-append leaves a torn tail that
        recovery truncates and readers never parse."""
        payload = json.dumps(doc, separators=(",", ":"),
                             sort_keys=True).encode()
        buf = pack_record(payload)
        # split the write so the armed chaos kill lands BETWEEN the two
        # halves — a genuinely torn record, not a clean boundary
        half = max(1, len(buf) // 2)
        self._f.write(buf[:half])
        try:
            maybe_kill("tsdb:append:mid")
        except BaseException:
            self._f.flush()
            raise
        self._f.write(buf[half:])
        self._active_bytes += len(buf)

    def _commit_file(self, final_name: str,
                     records: Optional[Iterable[dict]],
                     raw: Optional[bytes] = None) -> str:
        """THE rewrite path: encode ``records`` (or write ``raw`` bytes
        — the WRITER claim) into a temp file and ``os.replace`` it over
        ``final_name`` — a reader (or a crash) sees the whole new file
        or none of it. Rides the shared substrate's committed rewrite
        with the tsdb kill points threaded through ("mid-compaction" =
        meta record written, samples not)."""
        return logstore.commit_file(
            self.dir, final_name, records, raw=raw,
            kill_mid="tsdb:compact:mid",
            kill_pre_commit=("tsdb:roll:pre-commit",
                             "tsdb:compact:pre-commit"))

    # -- active-segment lifecycle --------------------------------------------
    def _new_segment_id(self, ts_ms: int) -> str:
        self._seq += 1
        return f"{ts_ms:013d}-{os.getpid() % 100000:05d}-{self._seq:04d}"

    def _ensure_active(self, ts_ms: int) -> None:
        if self._f is not None:
            return
        seg_id = self._new_segment_id(ts_ms)
        self._active_name = f"{ACTIVE_PREFIX}{seg_id}{SEGMENT_SUFFIX}"
        path = os.path.join(self.dir, self._active_name)
        # _ensure_active creates the empty active file the _append_payload helper
        # owns from here on; nothing is readable until a whole
        # checksummed record lands — append-in-place is this store's
        # discipline, not temp-write+rename
        self._f = open(path, "ab")
        self._active_bytes = 0
        self._active_started_ms = ts_ms
        self._emitted = set()
        self._last = {}
        self._last_ex = {}
        self._append_payload({"k": "seg", "v": 1, "t": ts_ms})

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def _seal(self, active_name: str, records: List[dict]) -> None:
        """Commit an active segment's whole records as a sealed segment
        (temp-write + rename), then drop the active file. Kill windows:
        pre-commit leaves active intact (roll simply re-runs); committed
        leaves both — recovery/readers dedupe by segment id."""
        seg_id = _segment_id(active_name)
        self._commit_file(f"{SEALED_PREFIX}{seg_id}{SEGMENT_SUFFIX}",
                          records)
        maybe_kill("tsdb:roll:committed")
        self._unlink(active_name)

    def roll(self) -> None:
        """Seal the active segment; the next append re-baselines every
        series in a fresh one."""
        if self._f is None:
            return
        self._f.flush()
        self._f.close()
        self._f = None
        name = self._active_name
        self._active_name = None
        records, clean = scan_records(os.path.join(self.dir, name))
        path = os.path.join(self.dir, name)
        if os.path.exists(path) and clean < os.path.getsize(path):
            os.truncate(path, clean)
        if records:
            self._seal(name, records)
        else:
            self._unlink(name)
        self._emitted = set()
        self._last = {}
        self._last_ex = {}

    def maybe_roll(self, now_ms: Optional[int] = None) -> bool:
        now_ms = _now_ms() if now_ms is None else now_ms
        if self._f is None:
            return False
        if (self._active_bytes >= self.segment_max_bytes
                or now_ms - self._active_started_ms
                >= self.segment_max_age_s * 1000.0):
            self.roll()
            return True
        return False

    # -- appends -------------------------------------------------------------
    def _sid(self, info_key: tuple, body: dict, ts_ms: int) -> int:
        sid = self._sids.get(info_key)
        if sid is None:
            sid = len(self._sids) + 1
            self._sids[info_key] = sid
            self._defs[sid] = body
        if sid not in self._emitted:
            self._ensure_active(ts_ms)
            self._append_payload({"k": "series", "id": sid,
                                  **self._defs[sid]})
            self._emitted.add(sid)
        return sid

    def append_snapshot(self, metrics: Dict[str, dict],
                        ts_ms: Optional[int] = None) -> int:
        """Fold one registry ``to_snapshot()`` export into the store;
        returns the number of samples appended. Series identity is the
        registry's own (name + labels + kind + buckets), so a rebooted
        process continues the same series — reads reconcile the counter
        reset, not the storage layer."""
        ts_ms = _now_ms() if ts_ms is None else ts_ms
        self._ensure_active(ts_ms)
        appended = 0
        for name, entry in sorted(metrics.items()):
            kind = entry.get("kind")
            if kind not in ("counter", "gauge", "histogram"):
                continue
            buckets = tuple(float(b) for b in entry.get("buckets", ()))
            for s in entry.get("series", ()):
                labels = {str(k): str(v)
                          for k, v in (s.get("labels") or {}).items()}
                key = (name, tuple(sorted(labels.items())), kind, buckets)
                body = {"name": name, "labels": labels, "kind": kind}
                if kind == "histogram":
                    body["buckets"] = list(buckets)
                sid = self._sid(key, body, ts_ms)
                if kind == "histogram":
                    counts = [float(c) for c in s.get("counts", ())]
                    total = float(s.get("sum", 0.0))
                    # exemplars ride the sample record ABSOLUTE (a
                    # handful of slots; delta-encoding evidence pointers
                    # would buy nothing and cost decode complexity)
                    ex = s.get("exemplars") or None
                    prev = self._last.get(sid)
                    if prev is not None and len(prev[0]) == len(counts):
                        doc = {"k": "h", "t": ts_ms, "id": sid,
                               "dc": [c - p for c, p in zip(counts,
                                                            prev[0])],
                               "dsum": total - prev[1]}
                    else:
                        doc = {"k": "h", "t": ts_ms, "id": sid,
                               "c": counts, "sum": total}
                    if ex and ex != self._last_ex.get(sid):
                        doc["ex"] = ex
                        self._last_ex[sid] = ex
                    self._append_payload(doc)
                    self._last[sid] = (counts, total)
                else:
                    value = float(s.get("value", 0.0))
                    prev = self._last.get(sid)
                    if prev is None:
                        self._append_payload({"k": "s", "t": ts_ms,
                                              "id": sid, "v": value})
                    else:
                        self._append_payload({"k": "s", "t": ts_ms,
                                              "id": sid, "d": value - prev})
                    self._last[sid] = value
                appended += 1
        return appended

    def append_event(self, event: dict,
                     ts_ms: Optional[int] = None) -> None:
        ts_ms = _now_ms() if ts_ms is None else ts_ms
        self._ensure_active(ts_ms)
        self._append_payload({"k": "e", "t": ts_ms, "e": event})

    def append_trace(self, record: dict,
                     ts_ms: Optional[int] = None) -> None:
        ts_ms = _now_ms() if ts_ms is None else ts_ms
        self._ensure_active(ts_ms)
        self._append_payload({"k": "tr", "t": ts_ms, "tr": record})

    # -- maintenance ---------------------------------------------------------
    def _sealed(self) -> List[str]:
        return [n for n in list_segments(self.dir)
                if n.startswith(SEALED_PREFIX)]

    def sweep(self, now_ms: Optional[int] = None) -> int:
        """Retention: drop sealed segments whose NEWEST record is past
        the horizon (a segment with one in-window sample stays whole —
        retention is a floor, not an exact cut; compaction trims the
        stragglers)."""
        now_ms = _now_ms() if now_ms is None else now_ms
        horizon = now_ms - self.retention_s * 1000.0
        dropped = 0
        for name in self._sealed():
            records, _ = scan_records(os.path.join(self.dir, name))
            newest = max((r.get("t", 0) for r in records), default=0)
            if newest < horizon:
                self._unlink(name)
                dropped += 1
        return dropped

    def compact(self, now_ms: Optional[int] = None) -> int:
        """Merge the sealed segments into one, dropping out-of-retention
        samples and re-delta-encoding — returns the number of input
        segments folded (0 = below the compaction threshold). The merged
        segment's meta names the inputs it ``replaces``; the commit is
        temp-write + rename, so a kill anywhere leaves either the inputs
        or the merged output authoritative, never both counted."""
        now_ms = _now_ms() if now_ms is None else now_ms
        inputs = self._sealed()
        if len(inputs) < self.compact_min_segments:
            return 0
        horizon = now_ms - self.retention_s * 1000.0
        reader = TSDBReader([self.dir])
        series = reader.series(since_ms=int(horizon),
                               _segments=[os.path.join(self.dir, n)
                                          for n in inputs])
        events = reader.events(since_ms=int(horizon),
                               _segments=[os.path.join(self.dir, n)
                                          for n in inputs])
        traces = reader.traces(since_ms=int(horizon),
                               _segments=[os.path.join(self.dir, n)
                                          for n in inputs])
        out: List[dict] = [{
            "k": "seg", "v": 1, "t": now_ms,
            "replaces": [_segment_id(n) for n in inputs]}]
        sid = 0
        for info in series:
            sid += 1
            body = {"name": info.name, "labels": info.labels,
                    "kind": info.kind}
            if info.kind == "histogram":
                body["buckets"] = list(info.buckets)
            out.append({"k": "series", "id": sid, **body})
            prev = None
            for point in info.points:
                if info.kind == "histogram":
                    ts, counts, total = point
                    if prev is not None and len(prev[0]) == len(counts):
                        doc = {"k": "h", "t": ts, "id": sid,
                               "dc": [c - p for c, p in
                                      zip(counts, prev[0])],
                               "dsum": total - prev[1]}
                    else:
                        doc = {"k": "h", "t": ts, "id": sid,
                               "c": list(counts), "sum": total}
                    if prev is None and info.exemplars:
                        # merged newest-per-bucket slots survive the
                        # fold; one absolute emission per series is
                        # enough (decode merges from any record)
                        doc["ex"] = [list(e) if e else None
                                     for e in info.exemplars]
                    out.append(doc)
                    prev = (counts, total)
                else:
                    ts, value = point
                    if prev is None:
                        out.append({"k": "s", "t": ts, "id": sid,
                                    "v": value})
                    else:
                        out.append({"k": "s", "t": ts, "id": sid,
                                    "d": value - prev})
                    prev = value
        out.extend({"k": "e", "t": ts, "e": e} for ts, e in events)
        out.extend({"k": "tr", "t": ts, "tr": t} for ts, t in traces)
        seg_id = self._new_segment_id(now_ms)
        self._commit_file(f"{SEALED_PREFIX}{seg_id}{SEGMENT_SUFFIX}", out)
        maybe_kill("tsdb:compact:committed")
        for name in inputs:
            self._unlink(name)
        return len(inputs)


def _now_ms() -> int:
    return int(time.time() * 1000)


# ---------------------------------------------------------------------------
# the read side: shared-nothing with the writer
# ---------------------------------------------------------------------------

def _decode_segment(path: str, process: Optional[str] = None,
                    missing_ok: bool = True
                    ) -> Tuple[dict, Dict[tuple, SeriesInfo],
                               List[tuple], List[tuple]]:
    """One segment's (meta, series-by-key, events, traces). Delta
    decoding is local to the segment (the format's self-containment
    contract); torn tails simply end the scan."""
    records, _ = scan_records(path, missing_ok=missing_ok)
    meta: dict = {}
    defs: Dict[int, SeriesInfo] = {}
    series: Dict[tuple, SeriesInfo] = {}
    cumulative: Dict[int, object] = {}
    events: List[tuple] = []
    traces: List[tuple] = []
    for r in records:
        k = r.get("k")
        if k == "seg" and not meta:
            meta = r
        elif k == "series":
            info = SeriesInfo(
                name=str(r.get("name", "")),
                labels={str(a): str(b)
                        for a, b in (r.get("labels") or {}).items()},
                kind=str(r.get("kind", "gauge")),
                buckets=tuple(float(b) for b in r.get("buckets", ())))
            if process is not None:
                info.labels.setdefault("process", process)
            defs[int(r.get("id", 0))] = info
        elif k == "s":
            info = defs.get(int(r.get("id", 0)))
            if info is None:
                continue
            if "v" in r:
                value = float(r["v"])
            else:
                prev = cumulative.get(id(info), 0.0)
                value = float(prev) + float(r.get("d", 0.0))
            cumulative[id(info)] = value
            series.setdefault(info.key() + ((process,)
                                            if process else ()), info)
            info.points.append((int(r.get("t", 0)), value))
        elif k == "h":
            info = defs.get(int(r.get("id", 0)))
            if info is None:
                continue
            if "c" in r:
                counts = [float(c) for c in r.get("c", ())]
                total = float(r.get("sum", 0.0))
            else:
                prev = cumulative.get(id(info))
                if prev is None:
                    continue
                counts = [p + d for p, d in
                          zip(prev[0], r.get("dc", ()))]
                total = prev[1] + float(r.get("dsum", 0.0))
            cumulative[id(info)] = (counts, total)
            series.setdefault(info.key() + ((process,)
                                            if process else ()), info)
            info.points.append((int(r.get("t", 0)), counts, total))
            if r.get("ex"):
                info.exemplars = merge_exemplar_slots(info.exemplars,
                                                      r["ex"])
        elif k == "e":
            events.append((int(r.get("t", 0)), r.get("e") or {}))
        elif k == "tr":
            traces.append((int(r.get("t", 0)), r.get("tr") or {}))
    return meta, series, events, traces


def adjust_resets(values: Sequence[float]) -> List[float]:
    """Counter-reset correction: a cumulative value that DROPS (process
    restart re-zeroed the registry) continues from the pre-drop level —
    the standard Prometheus ``increase()`` adjustment, so one series
    spans any number of process lifetimes."""
    out: List[float] = []
    offset, prev = 0.0, None
    for v in values:
        if prev is not None and v < prev:
            offset += prev
        prev = v
        out.append(v + offset)
    return out


class TSDBReader:
    """Range queries over one or many store directories (shared-nothing
    with the writer; safe from any process at any time). Multiple dirs
    merge as a fleet: pass ``{process_label: dir}`` (or a plain list)
    and every series gains a ``process`` label.

    A reader instance decodes each listing ONCE and memoizes it — it
    is a consistent snapshot, not a live view (a console page issuing
    eight queries must not re-read and re-CRC every segment eight
    times). Create a fresh reader to see newer data; the HTTP handlers
    and the CLI already do (one reader per request)."""

    def __init__(self, dirs):
        if isinstance(dirs, str):
            dirs = [dirs]
        if isinstance(dirs, dict):
            self._dirs = [(str(k), v) for k, v in sorted(dirs.items())]
        else:
            self._dirs = [(None, d) for d in dirs]
        self._memo: Dict[object, list] = {}

    def _segments(self) -> List[Tuple[Optional[str], str]]:
        out = []
        for process, d in self._dirs:
            names = list_segments(d)
            # a roll's commit window leaves BOTH seg-<id> and
            # active-<id> for an instant (and after a crash): count the
            # id once — the sealed copy wins
            sealed = {_segment_id(n) for n in names
                      if n.startswith(SEALED_PREFIX)}
            for name in names:
                if name.startswith(ACTIVE_PREFIX) \
                        and _segment_id(name) in sealed:
                    continue
                out.append((process, os.path.join(d, name)))
        return out

    def _decoded(self, _segments=None):
        # memoized per segment set (None = the live listing): one
        # console page (8 queries) or one compaction (series + events +
        # traces over the same inputs) decodes each segment once
        memo_key = tuple(_segments) if _segments is not None else None
        if memo_key in self._memo:
            return self._memo[memo_key]
        # a writer's roll/compaction can unlink a listed segment between
        # the listing and the read: its records moved to a NEW file this
        # listing doesn't know — re-list rather than under-count
        for attempt in range(5):
            segs = ([(None, p) for p in _segments]
                    if _segments is not None else self._segments())
            decoded = []
            replaced: set = set()
            stale = False
            for process, path in segs:
                try:
                    meta, series, events, traces = _decode_segment(
                        path, process, missing_ok=False)
                except OSError:
                    stale = _segments is None
                    if stale:
                        break
                    continue
                replaced.update(meta.get("replaces") or ())
                decoded.append((path, series, events, traces))
            if not stale:
                break
        # a compaction's inputs may still exist for one crash window (or
        # one concurrent-reader instant): the merged output wins
        out = [(path, series, events, traces)
               for path, series, events, traces in decoded
               if _segment_id(os.path.basename(path)) not in replaced]
        self._memo[memo_key] = out
        return out

    # -- series --------------------------------------------------------------
    def series(self, name: Optional[str] = None,
               labels: Optional[Dict[str, str]] = None,
               since_ms: Optional[int] = None,
               until_ms: Optional[int] = None,
               _segments=None) -> List[SeriesInfo]:
        """Merged series (points time-ordered across segments), filtered
        by metric name / label subset / time range."""
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        merged: Dict[tuple, SeriesInfo] = {}
        for _path, series, _e, _t in self._decoded(_segments):
            for info in series.values():
                if name is not None and info.name != name:
                    continue
                if any(info.labels.get(k) != v for k, v in want.items()):
                    continue
                key = info.key()
                out = merged.get(key)
                if out is None:
                    out = merged[key] = SeriesInfo(
                        info.name, dict(info.labels), info.kind,
                        info.buckets)
                out.points.extend(
                    p for p in info.points
                    if (since_ms is None or p[0] >= since_ms)
                    and (until_ms is None or p[0] <= until_ms))
                if info.exemplars:
                    out.exemplars = merge_exemplar_slots(out.exemplars,
                                                         info.exemplars)
        for info in merged.values():
            info.points.sort(key=lambda p: p[0])
        return sorted(merged.values(), key=lambda i: (i.name,
                                                      sorted(i.labels.items())))

    def events(self, since_ms: Optional[int] = None,
               _segments=None) -> List[tuple]:
        out = [(ts, e) for _p, _s, events, _t in self._decoded(_segments)
               for ts, e in events
               if since_ms is None or ts >= since_ms]
        out.sort(key=lambda x: x[0])
        return out

    def traces(self, since_ms: Optional[int] = None,
               _segments=None) -> List[tuple]:
        out = [(ts, t) for _p, _s, _e, traces in self._decoded(_segments)
               for ts, t in traces
               if since_ms is None or ts >= since_ms]
        out.sort(key=lambda x: x[0])
        return out

    # -- derived queries -----------------------------------------------------
    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             since_ms: Optional[int] = None,
             until_ms: Optional[int] = None) -> List[dict]:
        """Per-series per-second rate of a cumulative metric over the
        window, reset-adjusted (restarts never read as negative). The
        baseline is the newest sample AT OR BEFORE the window start
        (carry-back, the Prometheus ``increase`` shape); a series that
        starts inside the window counts from its first sample."""
        out = []
        for info in self.series(name, labels, None, until_ms):
            if info.kind == "histogram" or len(info.points) < 2:
                continue
            ts = [p[0] for p in info.points]
            adj = adjust_resets([p[1] for p in info.points])
            delta = _window_delta(ts, [adj], since_ms)
            if delta is None:
                continue
            (increase,), seconds = delta
            out.append({"labels": info.labels,
                        "rate": increase / seconds,
                        "increase": increase,
                        "seconds": seconds})
        return out

    def cumulative_points(self, name: str,
                          labels: Optional[Dict[str, str]] = None,
                          since_ms: Optional[int] = None,
                          until_ms: Optional[int] = None) -> List[tuple]:
        """The metric as ONE reset-adjusted cumulative series, summed
        across its label series with carry-forward alignment — scalars
        yield ``(ts, value)``, histograms ``(ts, counts, sum)`` (bucket
        layouts must agree; odd ones out are skipped). This is what SLO
        rehydration and quantile-over-time integrate over."""
        return self.cumulative_series(name, labels, since_ms, until_ms)[1]

    def cumulative_series(self, name: str,
                          labels: Optional[Dict[str, str]] = None,
                          since_ms: Optional[int] = None,
                          until_ms: Optional[int] = None
                          ) -> Tuple[Tuple[float, ...], List[tuple]]:
        """:meth:`cumulative_points` plus the bucket layout the
        histogram count vectors are laid out in (``()`` for scalars)."""
        all_series = self.series(name, labels, since_ms, until_ms)
        hists = [s for s in all_series if s.kind == "histogram"]
        if hists:
            layout = max({s.buckets for s in hists},
                         key=lambda b: sum(1 for s in hists
                                           if s.buckets == b))
            hists = [s for s in hists if s.buckets == layout]
            per = []
            for s in hists:
                ts = [p[0] for p in s.points]
                adj_counts = [adjust_resets([p[1][i] for p in s.points])
                              for i in range(len(layout) + 1)]
                adj_sum = adjust_resets([p[2] for p in s.points])
                per.append((ts, adj_counts, adj_sum))
            stamps = sorted({t for ts, _, _ in per for t in ts})
            out = []
            for t in stamps:
                counts = [0.0] * (len(layout) + 1)
                total = 0.0
                for ts, adj_counts, adj_sum in per:
                    idx = _at_or_before(ts, t)
                    if idx is None:
                        continue
                    for i in range(len(counts)):
                        counts[i] += adj_counts[i][idx]
                    total += adj_sum[idx]
                out.append((t, counts, total))
            return layout, out
        scalars = [s for s in all_series if s.kind != "histogram"]
        per = []
        for s in scalars:
            ts = [p[0] for p in s.points]
            per.append((ts, adjust_resets([p[1] for p in s.points])))
        stamps = sorted({t for ts, _ in per for t in ts})
        out = []
        for t in stamps:
            total = 0.0
            for ts, adj in per:
                idx = _at_or_before(ts, t)
                if idx is not None:
                    total += adj[idx]
            out.append((t, total))
        return (), out

    def histogram_window(self, name: str,
                         labels: Optional[Dict[str, str]] = None,
                         since_ms: Optional[int] = None,
                         until_ms: Optional[int] = None):
        """(buckets, per-bucket increase, count, sum-increase) over the
        window, summed across series — None when no histogram data.
        Same carry-back baseline semantics as :meth:`rate`; without
        ``since_ms`` the whole recorded (reset-adjusted) distribution
        counts."""
        hists = [s for s in self.series(name, labels, None, until_ms)
                 if s.kind == "histogram" and len(s.points) >= 1]
        if not hists:
            return None
        layout = max({s.buckets for s in hists},
                     key=lambda b: sum(1 for s in hists if s.buckets == b))
        counts = [0.0] * (len(layout) + 1)
        sum_inc = 0.0
        for s in hists:
            if s.buckets != layout:
                continue
            ts = [p[0] for p in s.points]
            per_bucket = [adjust_resets([p[1][i] for p in s.points])
                          for i in range(len(layout) + 1)]
            sums = adjust_resets([p[2] for p in s.points])
            delta = _window_delta(ts, per_bucket + [sums], since_ms,
                                  from_zero=True)
            if delta is None:
                continue
            increases, _seconds = delta
            for i in range(len(counts)):
                counts[i] += increases[i]
            sum_inc += increases[-1]
        return layout, counts, sum(counts), sum_inc

    def quantile_over_time(self, name: str, q: float,
                           labels: Optional[Dict[str, str]] = None,
                           since_ms: Optional[int] = None,
                           until_ms: Optional[int] = None
                           ) -> Optional[float]:
        """histogram_quantile over the window's per-bucket increases
        (linear interpolation inside the target bucket, observations
        past the last finite bound clamp to it — the registry/Prometheus
        convention)."""
        window = self.histogram_window(name, labels, since_ms, until_ms)
        if window is None:
            return None
        buckets, counts, total, _ = window
        return bucket_quantile(buckets, counts, q) if total > 0 else None


def _at_or_before(stamps: List[int], t: int) -> Optional[int]:
    """Index of the newest stamp <= t (carry-forward alignment)."""
    import bisect

    idx = bisect.bisect_right(stamps, t) - 1
    return idx if idx >= 0 else None


def _window_delta(ts: List[int], adj_list: List[List[float]],
                  since_ms: Optional[int], from_zero: bool = False
                  ) -> Optional[Tuple[List[float], float]]:
    """Window increases for reset-adjusted value vectors sharing the
    timestamps ``ts`` (already bounded by the window end). The baseline
    is the newest sample at or before ``since_ms`` (carry-back). With
    no such sample: ``from_zero=True`` counts everything recorded
    (quantile-over-time wants the distribution), ``from_zero=False``
    counts from the first sample (a rate needs a real span). Returns
    ``(increases, seconds)`` or None when the window holds nothing to
    measure."""
    if not ts:
        return None
    i1 = len(ts) - 1
    i0 = _at_or_before(ts, since_ms) if since_ms is not None else None
    if i0 is not None:
        if i0 >= i1:
            return None                     # no samples after the start
        base = [adj[i0] for adj in adj_list]
        t0 = ts[i0]
    elif from_zero:
        base = [0.0] * len(adj_list)
        t0 = since_ms if since_ms is not None else ts[0]
    else:
        if i1 == 0:
            return None
        base = [adj[0] for adj in adj_list]
        t0 = ts[0]
    seconds = (ts[i1] - t0) / 1000.0
    if seconds <= 0:
        seconds = 1e-9 if from_zero else 0.0
        if seconds == 0.0:
            return None
    return [adj[i1] - b for adj, b in zip(adj_list, base)], seconds


def bucket_quantile(buckets: Sequence[float], counts: Sequence[float],
                    q: float) -> float:
    """The registry Histogram.quantile math over a raw bucket layout."""
    total = sum(counts)
    if total <= 0 or not buckets:
        return 0.0
    target = q * total
    cumulative = 0.0
    for i, c in enumerate(counts):
        if cumulative + c >= target and c > 0:
            if i >= len(buckets):
                return buckets[-1]
            lower = buckets[i - 1] if i > 0 else 0.0
            upper = buckets[i]
            return lower + (upper - lower) * (target - cumulative) / c
        cumulative += c
    return buckets[-1]
