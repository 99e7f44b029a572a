"""Offline batch scoring: pipelined, sharded ``pio batchpredict`` (the
port of the reference's ``workflow/batch_predict.py``, JSON-lines only).

An input file of queries, one JSON object a line -> an engine instance
restored from the model store (or a caller's ``loaded`` models) ->
supplement / predict / serve per query -> one ``{"query": ...,
"prediction": ...}`` line a query, ``sort_keys`` JSON, in input order.

  * **pipelined** — a reader thread streams and decodes queries into
    bounded chunks, the scorer (the caller's thread, which owns the
    order of work on the card) drives the engine's batch path, and a
    writer thread serializes and writes completed chunks, so file I/O
    and JSON never hold the card back. The reader and writer never
    touch a CUDA tensor. ``pipelined=False`` runs the same stages
    inline (the measurement baseline).
  * **maximal buckets** — chunks pad up the ops/bucketing power-of-two
    ladder to ``chunk_size`` with sentinel indices, as the serving
    micro-batcher pads its drains; the padding is charged to throughput
    (``pio_batchpredict_pad_waste_rows_total``).
  * **lanes** — an engine whose single algorithm offers
    ``batch_predict_columnar``, behind the stock supplement and
    ``FirstServing.serve``, scores through it (JSON-ready wire dicts, no
    per-item dataclass); every other engine takes the generic lane
    (supplement / ``batch_predict`` / serve, with per-query isolation).
  * **sharded** — the ``PIO_PROCESS_ID`` / ``PIO_NUM_PROCESSES``
    contract (``parallel/distributed``) gives each process one
    contiguous row range. Each shard writes its fragment by temp-write
    + atomic rename; the last shard to finish claims a merge manifest
    (O_EXCL, under a lock on the output's directory) and concatenates
    the fragments in rank order into the final path, so the merged output is that of a single-process run and
    a kill at any point leaves nothing partial at the final path.

Malformed input rows (unparseable JSON, queries that do not fit the
engine's query class, rows an engine fails on) never abort the run:
each becomes a record in a ``<output>.errors.jsonl`` sidecar and an
increment of ``pio_batchpredict_invalid_queries_total``. A fault of the
card or of a kernel wrapper (``ops/kernels.is_device_error``) is not a
row's fault: it propagates and fails the run. Every time a lane fails
on a chunk and the chunk is scored again another way is counted in the
report (``lane_fallbacks``).

Parquet input, parquet output and the reference's arrow lane need
``pyarrow`` and are not ported yet: a ``.parquet``/``.pq`` path or the
``parquet`` format raises ``ValueError`` before any output is opened.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import logging
import os
import queue
import threading
import time
import uuid
from typing import Any, List, Optional, Tuple

from predictionio_tpu_torch.core.base import FirstServing, Serving
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import params_from_json
from predictionio_tpu_torch.obs import batch_stats
from predictionio_tpu_torch.obs import fleet as obs_fleet
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.trace_context import from_env, recorder
from predictionio_tpu_torch.obs.tracing import capture_context, carried, span
from predictionio_tpu_torch.ops.bucketing import bucket_size, padding_waste
from predictionio_tpu_torch.ops.kernels import is_device_error
from predictionio_tpu_torch.parallel.distributed import (
    contiguous_range, resolve_worker,
)
from predictionio_tpu_torch.server.query_server import _query_class
from predictionio_tpu_torch.storage.base import EngineInstance
from predictionio_tpu_torch.storage.faults import maybe_kill
from predictionio_tpu_torch.utils.device import DeviceLike
from predictionio_tpu_torch.utils.server_config import (
    BatchPredictConfig, batchpredict_config,
)

logger = logging.getLogger("pio.batchpredict")

_EOF = object()

#: where the formats this port does not read or write yet are queued
_PARQUET_ITEM = "ROADMAP.md Queue 1, A10b"


@dataclasses.dataclass
class BatchPredictReport:
    """What one batch-predict worker did (and, when it performed the
    shard merge or ran unsharded, the run totals). The reference's
    fields, then ``lane`` and ``lane_fallbacks``."""

    written: int = 0             # predictions THIS worker wrote
    invalid: int = 0             # sidecar error records THIS worker wrote
    chunks: int = 0
    pad_waste: int = 0
    seconds: float = 0.0
    rows_per_second: float = 0.0
    output_path: str = ""        # final path when merged, else fragment
    errors_path: Optional[str] = None
    worker: Tuple[int, int] = (0, 1)
    merged: bool = True          # False = this shard left a fragment only
    total_written: Optional[int] = None   # across shards (merger only)
    total_invalid: Optional[int] = None
    #: the run's trace id (PIO_TRACE_CONTEXT parent, else a fresh root);
    #: one id spans the parent and every shard of a fleet run
    trace_id: Optional[str] = None
    #: merged fleet observability (merger only): per-process metrics with
    #: a `process` label, exact counter totals, the fleet's trace records
    fleet: Optional[dict] = None
    #: the lane chunks were scored through: "columnar" or "generic"
    lane: str = "generic"
    #: chunks a lane failed on and that were scored again another way
    #: (columnar -> generic, or a batch -> one query at a time)
    lane_fallbacks: int = 0


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

_FIELD_NAMES: dict = {}


def fast_jsonable(obj: Any) -> Any:
    """The query server's `_to_jsonable` without `dataclasses.asdict`,
    which deep-copies every leaf it visits: the same JSON value (to_dict
    when offered, dataclass fields by name, containers recursively,
    leaves by reference), byte-identical once dumped with sort_keys."""
    if type(obj) in (str, int, float, bool, type(None)):
        return obj
    to_dict = getattr(obj, "to_dict", None)
    if callable(to_dict):
        return to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        t = type(obj)
        names = _FIELD_NAMES.get(t)
        if names is None:
            names = _FIELD_NAMES.setdefault(
                t, tuple(f.name for f in dataclasses.fields(t)))
        return {n: fast_jsonable(getattr(obj, n)) for n in names}
    if isinstance(obj, (list, tuple)):
        return [fast_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: fast_jsonable(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# input: JSON-lines -> decoded row stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Row:
    row: int                     # absolute input row number (0-based)
    raw: Any                     # original query value for the echo/sidecar
    query: Any = None            # decoded query object (None when error)
    error: Optional[str] = None


def _format_of(path: str, override: Optional[str] = None,
               default: Optional[str] = None) -> str:
    """Resolve a file format: an explicit per-invocation override wins,
    then a recognized extension, then the configured default — the host
    knob only names formats for extension-less paths."""
    if override:
        return override
    low = path.lower()
    if low.endswith((".parquet", ".pq")):
        return "parquet"
    if low.endswith((".jsonl", ".json", ".ndjson")):
        return "jsonl"
    return default or "jsonl"


def check_formats(input_path: str, output_path: str,
                  input_format: Optional[str] = None,
                  output_format: Optional[str] = None,
                  config: Optional[BatchPredictConfig] = None
                  ) -> Tuple[str, str]:
    """(input format, output format) of a run, resolved as the reference
    resolves them; raises ``ValueError`` for any but JSON-lines, before
    anything is read or written."""
    cfg = config or batchpredict_config()
    fmts = (_format_of(input_path, input_format),
            _format_of(output_path, output_format, cfg.output_format))
    for what, path, fmt in zip(("input", "output"),
                               (input_path, output_path), fmts):
        if fmt == "parquet":
            raise ValueError(
                f"batch predict {what} {path!r} is parquet: the port reads "
                f"and writes JSON-lines only; parquet needs pyarrow, which "
                f"it does not use yet ({_PARQUET_ITEM})")
        if fmt != "jsonl":
            raise ValueError(f"batch predict {what} format {fmt!r}: "
                             "expected jsonl")
    return fmts


def _count_input_rows(path: str) -> int:
    """Total query rows — the shard-range denominator: the non-blank
    lines (a fast byte scan)."""
    n = 0
    with open(path, "rb") as f:
        for line in f:
            if line.strip():
                n += 1
    return n


def _decode_obj(row: int, obj: Any, qc: Optional[type]) -> _Row:
    if qc is None:
        return _Row(row, obj, query=obj)
    try:
        return _Row(row, obj, query=params_from_json(obj, qc))
    except Exception as e:
        return _Row(row, obj,
                    error=f"query does not fit {qc.__name__}: {e}")


def _decode_text(row: int, text: str, qc: Optional[type]) -> _Row:
    try:
        obj = json.loads(text)
    except ValueError as e:
        return _Row(row, text, error=f"invalid JSON: {e}")
    return _decode_obj(row, obj, qc)


def _iter_rows(input_path: str, qc: Optional[type],
               lo: Optional[int] = None, hi: Optional[int] = None):
    """Decoded `_Row` stream for input rows [lo, hi) (everything when
    unbounded). Decoding runs here — on the READER thread of a
    pipelined run — so JSON parsing overlaps scoring."""
    row = 0
    with open(input_path) as f:
        for line in f:
            text = line.strip()
            if not text:
                continue
            r = row
            row += 1
            if lo is not None and r < lo:
                continue
            if hi is not None and r >= hi:
                break
            yield _decode_text(r, text, qc)


def _iter_chunks(rows_iter, chunk_size: int, registry: MetricsRegistry):
    chunk: List[_Row] = []
    while True:
        with span("batchpredict_read", registry=registry):
            for r in rows_iter:
                chunk.append(r)
                if len(chunk) >= chunk_size:
                    break
            else:
                break
        yield chunk
        chunk = []
    if chunk:
        yield chunk


# ---------------------------------------------------------------------------
# scorer: the bucketed batch path at the maximal bucket
# ---------------------------------------------------------------------------

class _ChunkScorer:
    """Score one decoded chunk through the engine's batch path.

    Mirrors the query server's `_predict_batch_unit` discipline —
    supplement, pad to the power-of-two bucket under sentinel indices,
    per-algorithm `batch_predict`, serve, with per-query error isolation
    — at the MAXIMAL bucket (`chunk_size`), no linger. Output entries are
    ``("json", wire_dict)`` from the columnar lane, ``("obj", served)``
    from the generic lane, or ``("err", message)``. A fault of the card
    or of a kernel wrapper propagates from every stage.
    """

    def __init__(self, result, max_bucket: int,
                 registry: MetricsRegistry):
        self.result = result
        self.max_bucket = max(1, max_bucket)
        self.registry = registry
        self.fast = self._lane_hook("batch_predict_columnar")
        self.pad_waste = 0
        self.fallbacks = 0
        self._queries = batch_stats.batch_queries_counter(registry)
        self._pad = batch_stats.batch_pad_waste(registry)
        self._chunk_hist = batch_stats.batch_chunk_seconds(registry)

    @property
    def lane(self) -> str:
        return "columnar" if self.fast is not None else "generic"

    def _lane_hook(self, name: str):
        """A dataclass-free scorer hook, eligible only when it provably
        changes nothing: ONE algorithm offering the hook, behind a
        passthrough supplement and stock FirstServing (any override could
        transform what the generic lane would have produced, so those
        engines keep the generic path)."""
        r = self.result
        if len(r.algorithms) != 1:
            return None
        hook = getattr(r.algorithms[0], name, None)
        if not callable(hook):
            return None
        s = type(r.serving)
        if s.supplement is not Serving.supplement:
            return None
        if s.serve is not FirstServing.serve:
            return None
        return hook

    def _padded(self, entries: List[Tuple[int, Any]], n_real: int):
        """Pad an indexed batch up its bucket with clones of the last
        real query under sentinel indices >= n_real; their predictions
        are computed and discarded. Returns (padded entries, waste rows)
        — the caller charges the waste ONCE per chunk, for whichever
        lane produced the chunk's final result."""
        bucket = bucket_size(len(entries), self.max_bucket)
        waste = padding_waste(len(entries), bucket)
        if waste:
            pad_q = entries[-1][1]
            entries = entries + [(n_real + j, pad_q) for j in range(waste)]
        return entries, waste

    @staticmethod
    def _row_fault(e: Exception) -> Exception:
        """``e`` when it is a row's own fault; re-raised when it is the
        card's or a kernel wrapper's."""
        if is_device_error(e):
            raise e
        return e

    def score(self, rows: List[_Row]) -> List[Tuple[str, Any]]:
        """Per-row ``("json"|"obj"|"err", payload)`` entries."""
        out: List[Optional[Tuple[str, Any]]] = [None] * len(rows)
        valid = []
        for i, r in enumerate(rows):
            if r.error is not None:
                out[i] = ("err", r.error)
            else:
                valid.append((i, r.query))
        if not valid:
            return out
        t0 = time.perf_counter()
        with span("batchpredict_score", registry=self.registry):
            if self.fast is not None:
                try:
                    waste = self._score_fast(valid, len(rows), out)
                except Exception as e:
                    self._row_fault(e)
                    logger.exception(
                        "columnar scoring lane failed; retrying the "
                        "chunk on the generic path")
                    self.fallbacks += 1
                    waste = self._score_generic(valid, len(rows), out)
            else:
                waste = self._score_generic(valid, len(rows), out)
        if waste:
            self._pad.inc(waste)
            self.pad_waste += waste
        self._chunk_hist.observe(time.perf_counter() - t0)
        self._queries.inc(len(valid))
        return out

    def _score_fast(self, valid, n_rows, out) -> int:
        batch, waste = self._padded(valid, n_rows)
        per = dict(self.fast(self.result.models[0], batch))
        for i, _ in valid:
            out[i] = ("json", per[i])
        return waste

    def _score_generic(self, valid, n_rows, out) -> int:
        result = self.result
        qmap = dict(valid)
        sup = []
        for i, q in valid:
            if out[i] is not None:     # columnar fallback may have partials
                out[i] = None
            try:
                sup.append((i, result.serving.supplement(q)))
            except Exception as e:
                out[i] = ("err", f"supplement failed: {self._row_fault(e)!r}")
        if not sup:
            return 0
        batch, waste = self._padded(sup, n_rows)
        try:
            per = {i: [] for i, _ in sup}
            for algo, model in zip(result.algorithms, result.models):
                for i, p in algo.batch_predict(model, batch):
                    if i in per:            # pad rows sliced off
                        per[i].append(p)
            for i, _ in sup:
                try:
                    out[i] = ("obj", result.serving.serve(qmap[i], per[i]))
                except Exception as e:
                    out[i] = ("err",
                              f"serve failed: {self._row_fault(e)!r}")
        except Exception as e:
            # poison query inside a vectorized batch_predict — isolate it
            # by falling back to per-query predict (the server rule)
            self._row_fault(e)
            self.fallbacks += 1
            for i, sq in sup:
                if out[i] is not None:
                    continue
                try:
                    preds = [a.predict(m, sq) for a, m in
                             zip(result.algorithms, result.models)]
                    out[i] = ("obj", result.serving.serve(qmap[i], preds))
                except Exception as e2:
                    out[i] = ("err",
                              f"predict failed: {self._row_fault(e2)!r}")
        return waste


# ---------------------------------------------------------------------------
# output: crash-safe JSON-lines sinks
# ---------------------------------------------------------------------------

class _JsonlSink:
    """Crash-safe output file: all bytes land in a same-directory temp
    file; `commit()` atomically renames it into place (so a kill at any
    moment leaves nothing partial visible at the target); `abort()`
    removes the temp."""

    def __init__(self, target: str):
        self.target = target
        self.tmp = f"{target}.tmp-{uuid.uuid4().hex}"
        self.rows = 0
        self._f = open(self.tmp, "w")

    def write_chunk(self, lines: List[str]) -> None:
        if lines:
            self._f.write("\n".join(lines) + "\n")
            self.rows += len(lines)

    def _close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def commit(self) -> None:
        self._close()
        os.replace(self.tmp, self.target)

    def abort(self) -> None:
        try:
            self._close()
        except Exception:
            pass
        try:
            if os.path.exists(self.tmp):
                os.unlink(self.tmp)
        except OSError:
            pass


class _Sidecar:
    """Lazy error sidecar: no invalid rows -> no file at all."""

    def __init__(self, target: str):
        self.target = target
        self._sink: Optional[_JsonlSink] = None
        self.rows = 0

    def record(self, row: _Row, message: str) -> None:
        if self._sink is None:
            self._sink = _JsonlSink(self.target)
        self._sink.write_chunk([json.dumps(
            {"row": row.row, "error": message, "query": row.raw},
            sort_keys=True, default=str)])
        self.rows += 1

    def commit(self) -> None:
        if self._sink is not None:
            self._sink.commit()
        else:
            # an error-free run must not leave a previous run's sidecar
            # at the target masquerading as this run's errors
            try:
                os.unlink(self.target)
            except OSError:
                pass

    def abort(self) -> None:
        if self._sink is not None:
            self._sink.abort()


class _Writer:
    """The serialize-and-write stage (the writer thread's work)."""

    def __init__(self, target: str, sidecar: _Sidecar,
                 registry: MetricsRegistry):
        self.sidecar = sidecar
        self.registry = registry
        self.sink = _JsonlSink(target)
        self.invalid_counter = batch_stats.batch_invalid_counter(registry)

    def write_chunk(self, rows: List[_Row], outs) -> None:
        with span("batchpredict_write", registry=self.registry):
            lines = []
            for r, (kind, payload) in zip(rows, outs):
                if kind == "err":
                    self._invalid(r, payload)
                    continue
                pj = payload if kind == "json" else fast_jsonable(payload)
                lines.append(json.dumps(
                    {"query": r.raw, "prediction": pj}, sort_keys=True))
            self.sink.write_chunk(lines)
        maybe_kill("batchpredict:chunk")

    def _invalid(self, row: _Row, message: str) -> None:
        self.sidecar.record(row, message)
        self.invalid_counter.inc()

    def commit(self) -> None:
        self.sink.commit()
        self.sidecar.commit()

    def abort(self) -> None:
        self.sink.abort()
        self.sidecar.abort()


# ---------------------------------------------------------------------------
# shard fragments + manifest merge
# ---------------------------------------------------------------------------

def _part_path(output: str, rank: int, size: int) -> str:
    return f"{output}.part-{rank:05d}-of-{size:05d}"


def _obs_path(output: str, rank: int, size: int) -> str:
    return f"{output}.obs-{rank:05d}-of-{size:05d}.json"


def _fleet_path(output: str) -> str:
    return f"{output}.fleet.json"


def _err_part_path(output: str, rank: int, size: int) -> str:
    return f"{output}.errors.part-{rank:05d}-of-{size:05d}"


def _meta_path(output: str, rank: int, size: int) -> str:
    return f"{output}.meta-{rank:05d}-of-{size:05d}.json"


def _manifest_path(output: str) -> str:
    return f"{output}.manifest.json"


def _input_fingerprint(input_path: str,
                       instance: Optional[EngineInstance]) -> List[Any]:
    """Identity of (input file, scored instance) for a fleet — recorded
    in every shard meta so completion markers from a DIFFERENT fleet
    generation (crash leftovers next to a since-rewritten input, or
    fragments scored with an older release) are never merged with fresh
    fragments. `loaded=` runs without an instance record "" — callers
    wiring their own models to a shared sharded output path must keep
    the model fixed across the fleet."""
    st = os.stat(input_path)
    return [st.st_mtime_ns, st.st_size,
            instance.id if instance is not None else ""]


def _write_meta(output: str, rank: int, size: int, written: int,
                invalid: int, fingerprint: List[Any]) -> None:
    """Commit this shard's completion record (temp-write + rename, AFTER
    its fragments are in place — the meta appearing atomically IS the
    shard's done marker)."""
    meta = _meta_path(output, rank, size)
    tmp = f"{meta}.tmp-{uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        json.dump({"rank": rank, "size": size, "rows": written,
                   "invalid": invalid, "input": fingerprint},
                  f, sort_keys=True)
    os.replace(tmp, meta)


def _read_meta(path: str, fingerprint: List[Any]) -> Optional[dict]:
    """A shard's meta, or None when it is missing, torn, or recorded
    against a different input file (a stale marker from a previous
    fleet — NOT done as far as this fleet is concerned)."""
    try:
        with open(path) as f:
            entry = json.load(f)
    except (OSError, ValueError):
        return None
    if entry.get("input") != fingerprint:
        return None
    return entry


def _clear_stale_rank_markers(output: str, rank: int, size: int) -> None:
    """A re-run must not let a PREVIOUS run's completion markers for
    this rank survive into its own fleet: remove the meta first (it is
    the done-marker, so there is no window where a stale fragment looks
    complete), then the fragments. Each shard clears only its OWN rank —
    a sibling's live markers from the same fleet stay usable."""
    for path in (_meta_path(output, rank, size),
                 _part_path(output, rank, size),
                 _err_part_path(output, rank, size),
                 _obs_path(output, rank, size)):
        try:
            os.unlink(path)
        except OSError:
            pass


def _maybe_merge(output: str, size: int,
                 fingerprint: List[Any]) -> Optional[dict]:
    """Merge shard fragments into the final output if every shard is
    done (a meta counts only when it matches THIS fleet's input
    fingerprint). The LAST shard to finish performs the merge; election
    is an O_EXCL create of the manifest, so exactly one merger claims
    it even when shards finish simultaneously. A pre-existing manifest
    is NOT a dead end: as long as every fragment + meta is present the
    merge is simply re-run (same fragments -> same bytes, committed by
    atomic rename), so a merger that crashed at ANY point — before or
    after the commit — is healed by the next run over the same path.
    Returns the run totals when this call merged, else None.

    The whole election and merge run under an exclusive ``flock`` of the
    output's directory: a shard that finishes while a sibling is
    mid-merge waits for it and then finds the metas gone, instead of
    rolling the live merge forward and reporting itself a merger too.
    A merger that crashed holds no lock, so the roll-forward still
    heals it."""
    fd = os.open(os.path.dirname(os.path.abspath(output)), os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        return _elect_and_merge(output, size, fingerprint)
    finally:
        os.close(fd)


def _elect_and_merge(output: str, size: int,
                     fingerprint: List[Any]) -> Optional[dict]:
    """``_maybe_merge``'s body, under its lock."""
    metas = [_meta_path(output, r, size) for r in range(size)]
    entries = [_read_meta(m, fingerprint) for m in metas]
    if any(e is None for e in entries):
        return None
    manifest = _manifest_path(output)
    try:
        fd = os.open(manifest, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return _roll_forward_merge(output, size, manifest, entries)
    with os.fdopen(fd, "w") as f:
        json.dump({"format": "jsonl", "shards": entries}, f, sort_keys=True)
    maybe_kill("batchpredict:merge")
    return _do_merge(output, size, entries)


def _roll_forward_merge(output: str, size: int, manifest: str,
                        entries: List[dict]) -> Optional[dict]:
    """A manifest already exists: a previous merger crashed mid-merge
    (no output yet) or right after its commit (output present but the
    stale claim survived — which would otherwise wedge every future
    fleet on this path), or a merger on another host, beyond
    ``_maybe_merge``'s lock, is mid-flight right now. Every meta
    already matched this fleet's fingerprint, so if the fragments are
    present too, re-run the merge — idempotent, so racing
    a live merger is harmless (_do_merge treats losing that race as
    success). Fragments missing with the output present is the normal
    already-merged-and-GC'd state: nothing to do."""
    parts = [_part_path(output, r, size) for r in range(size)]
    if not all(os.path.exists(p) for p in parts):
        if not os.path.exists(output):
            logger.warning(
                "merge manifest %s exists, the merged output is missing, "
                "and the shard fragments are incomplete — cannot roll the "
                "crashed merge forward; remove the manifest and re-run "
                "the shards", manifest)
        return None
    try:
        logger.info("re-running the merge claimed by existing manifest %s",
                    manifest)
        return _do_merge(output, size, entries)
    except OSError:
        if os.path.exists(output) and not os.path.exists(manifest):
            return None       # a concurrent merger committed and GC'd
        raise


def _do_merge(output: str, size: int, entries: List[dict]) -> dict:
    """Concatenate the shard fragments in rank order into the final path
    (temp-write + atomic rename), merge the error sidecars, then GC the
    manifest and fragments. Concurrent mergers (an O_EXCL winner racing
    a roll-forward, or two roll-forwards) build byte-identical content,
    so losing the race — our fragment reads failing because the winner
    committed and GC'd first — counts as success."""
    manifest = _manifest_path(output)
    metas = [_meta_path(output, r, size) for r in range(size)]
    parts = [_part_path(output, r, size) for r in range(size)]
    totals = {"written": sum(e["rows"] for e in entries),
              "invalid": sum(e["invalid"] for e in entries)}
    tmp = f"{output}.tmp-{uuid.uuid4().hex}"
    try:
        with open(tmp, "wb") as out_f:
            for part in parts:
                with open(part, "rb") as in_f:
                    while True:
                        buf = in_f.read(1 << 20)
                        if not buf:
                            break
                        out_f.write(buf)
        os.replace(tmp, output)                  # COMMIT
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        # the manifest is GC'd first below, so its absence alongside a
        # present output proves a concurrent merge committed — a real IO
        # failure leaves the claim in place and re-raises
        if os.path.exists(output) and not os.path.exists(manifest):
            logger.info("concurrent merger already committed %s", output)
            return totals
        raise

    # fleet observability merge: fold every shard's obs snapshot into
    # ONE view (per-process labels, exact counter sums, the union of
    # trace records) committed as <output>.fleet.json, and import the
    # fleet's traces into THIS process's flight recorder so one trace id
    # spans parent + shards. Snapshots already GC'd by a previous merge
    # leave the committed fleet.json in place.
    obs_paths = [p for p in (_obs_path(output, r, size)
                             for r in range(size)) if os.path.exists(p)]
    try:
        # best-effort by contract: the predictions are already committed,
        # and a bad shard snapshot (mixed code versions skewing histogram
        # buckets, a malformed series) must never fail the data path —
        # or leave the manifest claim wedged for every future fleet
        view = obs_fleet.merge_snapshot_files(obs_paths)
        if view.processes:
            fleet_doc = view.to_json()
            ftmp = f"{_fleet_path(output)}.tmp-{uuid.uuid4().hex}"
            try:
                with open(ftmp, "w") as f:
                    json.dump(fleet_doc, f, sort_keys=True)
                os.replace(ftmp, _fleet_path(output))
            except OSError:
                try:
                    os.unlink(ftmp)
                except OSError:
                    pass
            obs_fleet.import_into_recorder(view)
            totals["fleet"] = fleet_doc
    except Exception:
        logger.exception("fleet observability merge failed "
                         "(predictions are committed and unaffected)")

    err_parts = [p for p in
                 (_err_part_path(output, r, size) for r in range(size))
                 if os.path.exists(p)]
    try:
        if err_parts:
            etmp = f"{output}.errors.tmp-{uuid.uuid4().hex}"
            try:
                with open(etmp, "wb") as out_f:
                    for part in err_parts:
                        with open(part, "rb") as in_f:
                            out_f.write(in_f.read())
                os.replace(etmp, f"{output}.errors.jsonl")
            except OSError:
                try:
                    os.unlink(etmp)
                except OSError:
                    pass
                raise
        else:
            # an error-free merge must not leave a previous run's sidecar
            # next to the fresh output
            os.unlink(f"{output}.errors.jsonl")
    except OSError:
        # either the sidecar never existed, or a concurrent merger is
        # GC'ing the error fragments after committing the identical
        # merged sidecar
        pass

    # post-commit GC: the manifest FIRST — it is the merge claim, and a
    # surviving claim would outlive the fragments; everything behind it
    # is harmlessly redundant if we crash mid-loop
    for path in [manifest] + parts + metas + err_parts + obs_paths:
        try:
            os.unlink(path)
        except OSError:
            pass
    return totals


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class _StageFailed(Exception):
    """Internal: another pipeline stage died; unwind quietly."""


def _run_pipeline(chunks, scorer: _ChunkScorer, writer: _Writer,
                  queue_chunks: int, pipelined: bool) -> int:
    """Drive reader -> scorer -> writer; returns chunks scored. The
    scorer runs on the CALLING thread (it owns the order of work on the
    card); reading+decoding and serializing+writing ride two daemon
    threads behind bounded queues, and neither touches a CUDA tensor.
    Any stage failure stops the others promptly and re-raises here —
    including BaseException kill points, so a crash test dies exactly
    where it was injected."""
    if not pipelined:
        n = 0
        for rows in chunks:
            writer.write_chunk(rows, scorer.score(rows))
            n += 1
        return n

    in_q: "queue.Queue" = queue.Queue(maxsize=queue_chunks)
    out_q: "queue.Queue" = queue.Queue(maxsize=queue_chunks)
    stop = threading.Event()
    reader_exc: List[BaseException] = []
    writer_exc: List[BaseException] = []

    def _put(q, item) -> None:
        while True:
            if stop.is_set():
                raise _StageFailed()
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _get(q):
        while True:
            if stop.is_set():
                raise _StageFailed()
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                continue

    # both stage threads re-enter the run's trace (the shard runs under
    # tracing.adopt) so decode/commit I/O attributes to the batchpredict
    # trace id; record=False — the run-level span already records
    ctx = capture_context()

    def read_loop() -> None:
        try:
            with carried(ctx, "bp_reader", record=False):
                for rows in chunks:
                    _put(in_q, rows)
                _put(in_q, _EOF)
        except _StageFailed:
            pass
        except BaseException as e:       # noqa: BLE001 — incl. CrashError
            reader_exc.append(e)
            stop.set()

    def write_loop() -> None:
        try:
            with carried(ctx, "bp_writer", record=False):
                while True:
                    item = _get(out_q)
                    if item is _EOF:
                        return
                    writer.write_chunk(*item)
        except _StageFailed:
            pass
        except BaseException as e:       # noqa: BLE001 — incl. CrashError
            writer_exc.append(e)
            stop.set()

    rt = threading.Thread(target=read_loop, name="pio-bp-reader",
                          daemon=True)
    wt = threading.Thread(target=write_loop, name="pio-bp-writer",
                          daemon=True)
    rt.start()
    wt.start()
    n = 0
    try:
        while True:
            item = _get(in_q)
            if item is _EOF:
                _put(out_q, _EOF)
                break
            _put(out_q, (item, scorer.score(item)))
            n += 1
    except _StageFailed:
        pass
    except BaseException:
        stop.set()
        raise
    finally:
        # settle both stages before inspecting their fate: a failed run
        # gets bounded joins after stop (a hung stage must not wedge the
        # unwind), a healthy one joins unbounded — the writer may
        # legitimately need longer than any timeout to drain the queue
        # tail, and committing before it finishes would truncate the
        # output
        if reader_exc or writer_exc or stop.is_set():
            stop.set()
            rt.join(timeout=30)
            wt.join(timeout=30)
        else:
            rt.join()
            wt.join()
    if writer_exc:
        raise writer_exc[0]
    if reader_exc:
        raise reader_exc[0]
    if rt.is_alive() or wt.is_alive():
        raise RuntimeError(
            "batch-predict pipeline stage did not settle after failure; "
            "aborting instead of committing a possibly-truncated output")
    return n


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run_batch_predict(engine: Optional[Engine],
                      instance: Optional[EngineInstance],
                      input_path: str, output_path: str,
                      chunk_size: Optional[int] = None, *,
                      output_format: Optional[str] = None,
                      input_format: Optional[str] = None,
                      variant_conf: Optional[dict] = None,
                      config: Optional[BatchPredictConfig] = None,
                      loaded: Optional[tuple] = None,
                      pipelined: Optional[bool] = None,
                      worker: Optional[Tuple[int, int]] = None,
                      registry: Optional[MetricsRegistry] = None,
                      device: DeviceLike = None
                      ) -> BatchPredictReport:
    """Score a file of queries offline; returns a BatchPredictReport.

    Explicit arguments beat the resolved config (env >
    engine.json ``batchpredict`` section (``variant_conf``) >
    server.json). ``loaded=(result, ctx)`` skips the model-store restore
    (tests and the smoke with models of their own); otherwise the
    instance's models load onto ``device`` (None: ``cuda``).
    ``worker=(rank, size)`` pins the shard identity instead of reading
    the PIO_* process env.
    """
    cfg = config or batchpredict_config(variant_conf)
    check_formats(input_path, output_path, input_format, output_format,
                  cfg)
    chunk = max(1, chunk_size if chunk_size is not None else cfg.chunk_size)
    pipe = cfg.pipelined if pipelined is None else pipelined
    rank, size = resolve_worker(*(worker or (None, None)))
    registry = registry or default_registry()

    if loaded is not None:
        result = loaded[0]
    else:
        from predictionio_tpu_torch.workflow.train import load_for_deploy

        result, _ctx = load_for_deploy(engine, instance, device=device)
    qc = _query_class(result)

    lo = hi = None
    if size > 1:
        n_rows = _count_input_rows(input_path)
        lo, hi = contiguous_range(n_rows, rank, size)
        target = _part_path(output_path, rank, size)
        err_target = _err_part_path(output_path, rank, size)
        _clear_stale_rank_markers(output_path, rank, size)
    else:
        target = output_path
        err_target = f"{output_path}.errors.jsonl"

    scorer = _ChunkScorer(result, chunk, registry)
    writer = _Writer(target, _Sidecar(err_target), registry)
    t0 = time.perf_counter()
    # the whole shard run is ONE trace: a parent that spawned this
    # process hands its context via PIO_TRACE_CONTEXT (obs/trace_context)
    # and every shard of the fleet then shares the parent's trace id; a
    # standalone run roots a fresh one. The completed-run record (with
    # the read/score/write span totals) lands in the flight recorder and
    # rides the shard's obs snapshot to the merger.
    parent_ctx = from_env()
    run_name = (f"batchpredict shard {rank}/{size}" if size > 1
                else "batchpredict")
    try:
        with carried(parent_ctx, run_name, registry=registry,
                     attrs={"input": os.path.basename(input_path),
                            "output": os.path.basename(output_path),
                            "rank": rank, "size": size}) as run_trace:
            trace_id = run_trace.trace_id
            chunks = _iter_chunks(_iter_rows(input_path, qc, lo, hi),
                                  chunk, registry)
            n_chunks = _run_pipeline(chunks, scorer, writer,
                                     cfg.queue_chunks, pipe)
            writer.commit()
    except BaseException:
        writer.abort()
        raise
    seconds = time.perf_counter() - t0

    written = writer.sink.rows
    invalid = writer.sidecar.rows
    rps = written / seconds if seconds > 0 else 0.0
    batch_stats.batch_rows_per_second(registry).set(rps)
    report = BatchPredictReport(
        written=written, invalid=invalid, chunks=n_chunks,
        pad_waste=scorer.pad_waste, seconds=seconds, rows_per_second=rps,
        output_path=target,
        errors_path=(writer.sidecar.target if invalid else None),
        worker=(rank, size), merged=(size == 1),
        total_written=written if size == 1 else None,
        total_invalid=invalid if size == 1 else None,
        trace_id=trace_id, lane=scorer.lane,
        lane_fallbacks=scorer.fallbacks)

    if size > 1:
        fp = _input_fingerprint(input_path, instance)
        # push this shard's observability to the merger: registry
        # snapshot + this run's trace records, committed BEFORE the meta
        # done-marker so the merging shard always finds it
        doc = obs_fleet.snapshot(registry, process=f"{rank}/{size}",
                                 include_traces=False,
                                 extra={"worker": [rank, size],
                                        "traceId": trace_id})
        doc["traces"] = recorder().traces(trace_id=trace_id)
        doc["events"] = [e for e in recorder().events()
                         if e.get("traceId") == trace_id]
        obs_fleet.write_snapshot(_obs_path(output_path, rank, size), doc)
        _write_meta(output_path, rank, size, written, invalid, fp)
        totals = _maybe_merge(output_path, size, fp)
        if totals is not None:
            report.merged = True
            report.output_path = output_path
            report.total_written = totals["written"]
            report.total_invalid = totals["invalid"]
            report.fleet = totals.get("fleet")
            report.errors_path = (f"{output_path}.errors.jsonl"
                                  if totals["invalid"] else None)
    logger.info(
        "batch predict%s: %d predictions (%d invalid, %d pad rows, "
        "%.0f rows/s, %s lane, %d lane fallbacks) -> %s",
        f" shard {rank}/{size}" if size > 1 else "",
        report.written, report.invalid, report.pad_waste, rps,
        scorer.lane, scorer.fallbacks, report.output_path)
    return report
