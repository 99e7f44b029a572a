"""Online fold-in: fresh events reach served recommendations between
full retrains (port of the reference's ``deploy/foldin.py``).

With the opposite side's factors frozen, one entity's row is a small
independent least-squares solve, so every pending row of a side goes
through ONE batched solve (:class:`models.als.FoldInSolver`, B1 on the
card).

Events reach the controller two ways, which overlap by design:

* **push** — a tap on the group-commit ``WriteBuffer`` flush
  (``data/write_buffer``): an event server in this process marks
  entities dirty as soon as their events are committed;
* **pull** — a scan of the event store since the event-time watermark
  on every apply tick, for events another process ingested. A bounded
  set of seen event ids drops the overlap. Events with a backdated
  ``eventTime`` are caught only by push: the scan reads by event time.

Each apply tick pulls, takes up to ``max_pending`` dirty entities,
reads each one's FULL rating history (one store query per side for the
whole tick; the solve is exact least squares over all of an entity's
ratings, as a retrain would solve it), solves each side in one batched
call and hands the engine's ``foldin_apply`` hook the rows. The new
model is swapped in with the ``/reload`` discipline as a compare-and-
swap: a reload or rollback that landed during the solve wins, and the
deltas go back to pending. The first apply after a real deploy
registers one drift release; the pre-fold-in unit stays resident as the
rollback standby, and ``POST /rollback.json`` restores its answers.

On a partitioned event store (``PIO_INGEST_PARTITIONS``,
``storage/partitioned``) the pull scan reads the partitions at once and
concatenates them, and the history read groups a tick's user ids by
``partition_of``, so each partition is asked only for its own users
(an entity's events all live in one partition); the item side's
``target_entity_id`` is not hashed and asks every partition. Both
return the rows the unpartitioned store returns.

The controller counts into the registry series of ``obs/foldin_stats``
(applies by outcome, applied and pending rows, the apply, solve and
event-to-applied times) and keeps a log of its recent applies, which
``status_dict`` (``GET /deploy/status.json``) reports. Each tap
captures the trace context it runs in (the write buffer's flush carries
the ingest request's), and the next apply re-enters the last one as a
``foldin_apply`` span, so one trace id stitches ingest request, flush,
apply and swap; an apply that raced a cutover or failed keeps the
context for the retry.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.bimap import batch_lookup, vocab_index
from predictionio_tpu_torch.models.als import ALSParams, FoldInSolver
from predictionio_tpu_torch.obs.foldin_stats import (
    foldin_applied_rows, foldin_applies, foldin_apply_seconds,
    foldin_batch_rows, foldin_event_to_applied, foldin_pending,
    foldin_solve_seconds,
)
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.obs.tracing import capture_context, carried
from predictionio_tpu_torch.storage.base import Release
from predictionio_tpu_torch.utils.server_config import FoldinConfig

logger = logging.getLogger("pio.torch.foldin")

#: bounded dedup window between the push tap and the pull scan
SEEN_IDS_MAX = 16384
#: entity ids per history query (well under sqlite's bound-variable cap)
READ_CHUNK = 500
#: applies kept in ``status_dict()["recentApplies"]``
APPLY_LOG = 256


class FoldinUnsupported(Exception):
    """The deployed engine cannot fold in (no or ambiguous hooks)."""


@dataclasses.dataclass
class FoldinSpec:
    """How one algorithm's events map to fold-in deltas; engines return
    it from ``Algorithm.foldin_spec(model, engine_params)``."""

    app_name: str
    als_params: ALSParams            # reg/alpha/implicit/weighted for solves
    entity_type: str = "user"
    target_entity_type: str = "item"
    #: events that produce rating rows for the entity's solve
    event_names: Tuple[str, ...] = ()
    #: value per event name (an event absent here counts 1.0)
    event_weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: event whose value comes from properties["rating"] (None = none)
    rate_event: Optional[str] = None
    #: "rows" = every event is one rating row; "sum" = weights summed per
    #: (entity, target) pair
    aggregate: str = "rows"
    #: also fold target-side (item) rows against the updated users
    fold_items: bool = False
    #: events feeding incremental count deltas (no ported engine yet)
    count_events: Tuple[str, ...] = ()
    channel_name: Optional[str] = None


@dataclasses.dataclass
class FoldinFactors:
    """An engine's factor model as the controller reads it
    (``Algorithm.foldin_factors(model)``). ``device_copy`` returns the
    resident device copy of V; it is called only when a solve needs it,
    so the push tap's vocab lookups never upload V."""

    user_vocab: np.ndarray
    item_vocab: np.ndarray
    U: np.ndarray
    V: np.ndarray
    device_copy: Optional[Callable[[], object]] = None

    @property
    def V_device(self):
        return self.device_copy() if self.device_copy is not None else None


def upsert_factor_rows(vocab: np.ndarray, M: np.ndarray,
                       rows: Dict[str, np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Insert or overwrite factor rows by string id, keeping the vocab
    sorted (the ``vocab_index`` binary-search contract; a fixed-width
    string vocab widens to fit a longer new id). Returns ``(vocab',
    M')``; the inputs are never mutated, and with no rows they are
    returned as they are."""
    if not rows:
        return vocab, M
    M2 = np.array(M, copy=True)
    fresh: List[Tuple[str, np.ndarray]] = []
    for rid, row in rows.items():
        idx = vocab_index(vocab, rid)
        if idx is None:
            fresh.append((str(rid), np.asarray(row, M2.dtype)))
        else:
            M2[idx] = row
    if not fresh:
        return vocab, M2
    fresh.sort(key=lambda t: t[0])
    ids = np.asarray([t[0] for t in fresh], dtype=object)
    if vocab.dtype.kind == "U":
        # a fixed-width vocab (a model built from numpy strings) widens,
        # so a longer new id is not cut to the old width
        width = max(vocab.dtype.itemsize // 4, max(len(i) for i in ids))
        vocab = vocab.astype(f"<U{width}", copy=False)
        ids = ids.astype(vocab.dtype)
    new_rows = np.stack([t[1] for t in fresh])
    pos = np.searchsorted(vocab, ids)
    return (np.insert(vocab, pos, ids),
            np.insert(M2, pos, new_rows, axis=0))


def _ratings_of(spec: FoldinSpec, events: np.ndarray, others: np.ndarray,
                properties: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(others, values) of event rows under the spec's event->value
    mapping; a rate event without a rating property is dropped (the
    training read raises; the online path keeps serving)."""
    from predictionio_tpu_torch.data.eventstore import property_column

    values = np.ones(len(events), np.float32)
    for name in set(events.tolist()):
        if name != spec.rate_event:
            values[events == name] = float(spec.event_weights.get(name, 1.0))
    if spec.rate_event is not None:
        is_rate = events == spec.rate_event
        if is_rate.any():
            values[is_rate] = property_column(properties[is_rate], "rating")
    keep = np.fromiter((o is not None for o in others), bool,
                       count=len(others)) & ~np.isnan(values)
    others, values = others[keep], values[keep]
    if spec.aggregate == "sum" and len(others):
        uniq, inv = np.unique(others, return_inverse=True)
        sums = np.zeros(len(uniq), np.float32)
        np.add.at(sums, inv, values)
        return uniq, sums
    return others, values


def read_entities_ratings(spec: FoldinSpec, entity_ids: Sequence[str],
                          side: str = "user"
                          ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Each entity's FULL rating history, ``{id: (opposite-side ids,
    values)}``: the training read's semantics restricted to these
    entities, one store query per ``READ_CHUNK`` of them (the reference
    queries once per entity; the rows are the same)."""
    from predictionio_tpu_torch.data.eventstore import EventStoreClient

    key, other = (("entity_id", "target_entity_id") if side == "user"
                  else ("target_entity_id", "entity_id"))
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    ids = [str(e) for e in entity_ids]
    for s in range(0, len(ids), READ_CHUNK):
        chunk = ids[s:s + READ_CHUNK]
        cols = EventStoreClient.find_columns(
            spec.app_name, spec.channel_name,
            event_names=list(spec.event_names), ordered=False,
            columns=("event", key, other, "properties"),
            entity_type=spec.entity_type,
            target_entity_type=spec.target_entity_type, **{key: chunk})
        ents = cols[key]
        # a stable sort keeps each entity's rows in the store's order,
        # the order its own query would return them in
        order = np.argsort(ents, kind="stable")
        bounds = np.flatnonzero(ents[order][1:] != ents[order][:-1]) + 1
        for rows in np.split(order, bounds) if len(order) else ():
            out[str(ents[rows[0]])] = _ratings_of(
                spec, cols["event"][rows], cols[other][rows],
                cols["properties"][rows])
    empty = (np.asarray([], dtype=object), np.zeros(0, np.float32))
    return {e: out.get(e, empty) for e in ids}


def read_entity_ratings(spec: FoldinSpec, entity_id: str,
                        side: str = "user") -> Tuple[np.ndarray, np.ndarray]:
    """One entity's FULL rating history: (opposite-side ids, values)."""
    return read_entities_ratings(spec, [entity_id], side)[str(entity_id)]


def resolve_foldin(result) -> Optional[Tuple[int, FoldinSpec]]:
    """The (algorithm index, spec) a TrainResult folds through, or None.
    Exactly ONE algorithm may implement the hooks: with several, which
    model absorbs an event is ambiguous."""
    hits = []
    for i, (algo, model) in enumerate(zip(result.algorithms,
                                          result.models)):
        fn = getattr(algo, "foldin_spec", None)
        if fn is None:
            continue
        try:
            spec = fn(model, result.engine_params)
        except Exception:
            logger.exception("foldin_spec failed on %s",
                             type(algo).__name__)
            continue
        if spec is not None:
            hits.append((i, spec))
    return hits[0] if len(hits) == 1 else None


def register_drift_release(base: Release) -> Optional[Release]:
    """Register the fold-in drift of ``base`` as its own release row
    (LIVE, ``model_digest`` empty: the served model drifts from the
    blob) and retire ``base``: one row per drift generation, so
    ``/rollback.json`` has a row to mark ROLLED_BACK. When several
    servers fold the same base at once, they converge on the lowest
    version and retire the rest. Best effort: a registry outage never
    stops fold-in (returns None)."""
    from predictionio_tpu_torch.storage.registry import Storage

    now_ms = int(time.time() * 1000)
    drift = Release(
        engine_id=base.engine_id,
        engine_version=base.engine_version,
        engine_variant=base.engine_variant,
        instance_id=base.instance_id,
        params_digest=base.params_digest,
        model_digest="",
        status="LIVE",
        batch=f"foldin drift of v{base.version}",
        history=[
            {"status": "REGISTERED", "timeMs": now_ms,
             "reason": f"online fold-in drift of release v{base.version}"},
            {"status": "LIVE", "timeMs": now_ms,
             "reason": "first fold-in apply"},
        ],
    )
    try:
        releases = Storage.get_meta_data_releases()
        releases.insert(drift)
        peers = sorted(
            (r for r in releases.get_all()
             if r.status == "LIVE" and r.batch == drift.batch),
            key=lambda r: r.version)
        for extra in peers[1:]:
            releases.set_status(
                extra.id, "RETIRED",
                reason=f"duplicate drift row; v{peers[0].version} wins")
        if peers and peers[0].id != drift.id:
            drift = peers[0]
        releases.set_status(base.id, "RETIRED",
                            reason=f"superseded: fold-in drift v"
                                   f"{drift.version}")
        logger.info("registered fold-in drift release v%d over v%d",
                    drift.version, base.version)
        return drift
    except Exception:
        logger.exception("fold-in drift registration failed")
        return None


class FoldInController:
    """Collects event deltas (push tap and pull scan), batch-solves the
    pending rows on the server's device and swaps the updated model into
    the live serving unit on a bounded cadence. The tap runs on the
    ingest writer thread, applies on the server's deploy executor (or
    the caller's thread), and the swap is one reference assignment."""

    def __init__(self, server, config: FoldinConfig, registry=None):
        self.server = server
        self.config = config
        # the server's registry; a bare controller keeps its own
        reg = (registry or getattr(server, "registry", None)
               or MetricsRegistry())
        sup = resolve_foldin(server.result)
        if sup is None:
            raise FoldinUnsupported(
                "no single algorithm with foldin hooks in this engine")
        self.algo_index, self.spec = sup
        names = set(self.spec.event_names) | set(self.spec.count_events)
        self._all_events = tuple(sorted(names))
        self._lock = threading.Lock()
        self._dirty_users: "OrderedDict[str, float]" = OrderedDict()
        self._dirty_items: "OrderedDict[str, float]" = OrderedDict()
        self._counts: Dict[str, float] = {}
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._watermark_ms = int(time.time() * 1000)
        self._app: Optional[Tuple[int, Optional[int]]] = None
        self._app_warned = False
        self._solver_cache: Optional[Tuple[np.ndarray, FoldInSolver]] = None
        self._vocab_cache: Optional[Tuple[object, np.ndarray]] = None
        self._loop = None
        self._task = None
        self._kick: Optional[threading.Event] = None
        #: the last tap's captured trace context, re-entered by the
        #: next apply
        self._last_trace = None
        self._registry = reg
        self.applied_users = 0
        self.applied_items = 0
        self.applies = 0
        #: batched solves run (one B1 call each on the card)
        self.solves = 0
        self.last_apply_s: Optional[float] = None
        #: the reference's ``pio_foldin_*`` series (obs/foldin_stats);
        #: apply ticks by outcome: applied | empty | raced | held |
        #: deferred | error
        self._m_pending = foldin_pending(reg)
        self._m_batch = foldin_batch_rows(reg)
        self._m_solve = foldin_solve_seconds(reg)
        self._m_apply = foldin_apply_seconds(reg)
        self._m_rows = foldin_applied_rows(reg)
        self._m_applies = foldin_applies(reg)
        self._m_latency = foldin_event_to_applied(reg)
        #: the recent applies' splits (see `_apply`)
        self.apply_log: "deque[dict]" = deque(maxlen=APPLY_LOG)

    # -- delta collection ----------------------------------------------------
    def pending_rows(self) -> int:
        with self._lock:
            return len(self._dirty_users) + len(self._dirty_items)

    def _update_pending_gauge(self) -> None:
        self._m_pending.set(float(self.pending_rows()))

    @property
    def outcomes(self) -> Dict[str, int]:
        """Apply ticks by outcome so far."""
        return {labels["outcome"]: int(v)
                for labels, v in self._m_applies.samples()}

    def _resolve_app(self) -> Optional[Tuple[int, Optional[int]]]:
        if self._app is None:
            from predictionio_tpu_torch.data.eventstore import resolve_app

            try:
                self._app = resolve_app(self.spec.app_name,
                                        self.spec.channel_name)
            except Exception:
                if not self._app_warned:
                    logger.warning(
                        "fold-in cannot resolve app %r yet; deltas are "
                        "dropped until it exists", self.spec.app_name)
                    self._app_warned = True
                return None
        return self._app

    def tap(self, events, app_id, channel_id) -> None:
        """The WriteBuffer flush tap: on the ingest writer thread, after
        a committed group commit; it only filters and marks."""
        app = self._resolve_app()
        if app is None or (app_id, channel_id) != app:
            return
        self.offer(events)

    def offer(self, events) -> None:
        """Mark the entities behind ``events`` (``data.event.Event``)
        dirty, once per event id; other event names and entity types are
        ignored."""
        now = time.monotonic()
        # the tap runs inside the flush's carried trace: the apply that
        # folds these events stays on its trace id (None: tracing off)
        ctx = capture_context()
        if ctx is not None:
            self._last_trace = ctx
        with self._lock:
            for e in events:
                if not self._first_sight(e.event_id):
                    continue
                self._mark_locked(e.event, e.entity_type, e.entity_id,
                                  e.target_entity_type, e.target_entity_id,
                                  now)
            pending = len(self._dirty_users) + len(self._dirty_items)
        self._m_pending.set(float(pending))
        kick = pending >= self.config.max_pending
        if kick and self._kick is not None:
            self._kick.set()

    def _first_sight(self, event_id) -> bool:
        """False for an event id seen before (under the lock)."""
        if not event_id:
            return True
        if event_id in self._seen:
            return False
        self._seen[event_id] = None
        while len(self._seen) > SEEN_IDS_MAX:
            self._seen.popitem(last=False)
        return True

    def _mark_locked(self, event, entity_type, entity_id,
                     target_entity_type, target_entity_id, now) -> None:
        spec = self.spec
        if entity_type != spec.entity_type or not entity_id:
            return
        relevant = event in spec.event_names and (
            target_entity_type is None
            or target_entity_type == spec.target_entity_type)
        if relevant:
            self._dirty_users.setdefault(entity_id, now)
            # only items the model has never seen fold in: a known item
            # refreshing with every rating would re-solve (and re-swap V
            # for) much of the catalog under steady traffic
            if (spec.fold_items and target_entity_id
                    and not self._known_item(target_entity_id)):
                self._dirty_items.setdefault(target_entity_id, now)
        if event in spec.count_events and target_entity_id:
            self._counts[target_entity_id] = \
                self._counts.get(target_entity_id, 0.0) + 1.0

    def _known_item(self, item_id: str) -> bool:
        """Is ``item_id`` in the serving model's item vocab? (Unknown on
        any failure, so a questionable id still gets a fold attempt.)"""
        try:
            unit = self.server._unit
            model = unit.result.models[self.algo_index]
            cached = self._vocab_cache
            if cached is None or cached[0] is not model:
                algo = unit.result.algorithms[self.algo_index]
                cached = (model, algo.foldin_factors(model).item_vocab)
                self._vocab_cache = cached
            return vocab_index(cached[1], item_id) is not None
        except Exception:
            return False

    def pull(self) -> None:
        """Scan events since the event-time watermark: the path for
        events another process ingested. Overlap with pushed events is
        dropped by event id."""
        app = self._resolve_app()
        if app is None:
            return
        import datetime as _dt

        from predictionio_tpu_torch.data.event import UTC
        from predictionio_tpu_torch.data.eventstore import EventStoreClient

        since = _dt.datetime.fromtimestamp(self._watermark_ms / 1000.0,
                                           tz=UTC)
        cols = EventStoreClient.find_columns(
            self.spec.app_name, self.spec.channel_name,
            start_time=since, entity_type=self.spec.entity_type,
            event_names=list(self._all_events), ordered=False,
            columns=("event_id", "event", "entity_id",
                     "target_entity_type", "target_entity_id",
                     "event_time_ms"))
        ids = cols["event_id"]
        if not len(ids):
            return
        events, ents = cols["event"], cols["entity_id"]
        ttypes, tids = cols["target_entity_type"], cols["target_entity_id"]
        now = time.monotonic()
        with self._lock:
            for i in range(len(ids)):
                if self._first_sight(ids[i]):
                    self._mark_locked(events[i], self.spec.entity_type,
                                      ents[i], ttypes[i], tids[i], now)
            # the watermark stays AT the newest time seen (not +1 ms): a
            # same-millisecond straggler lands in the next scan and the
            # seen-id set drops the repeat
            self._watermark_ms = max(self._watermark_ms,
                                     int(cols["event_time_ms"].max()))
        self._update_pending_gauge()

    def release_device(self) -> None:
        """Forget the solver (its device copy of the factors) and the
        vocab cache (a model): the server's unit was evicted."""
        self._solver_cache = None
        self._vocab_cache = None

    # -- apply ---------------------------------------------------------------
    def _solver_for(self, factors: np.ndarray, params: ALSParams,
                    device, factors_device=None) -> FoldInSolver:
        """The solver of this factor matrix: its device copy and implicit
        Gramian survive across applies until the matrix itself changes
        (an item fold, a reload, a rollback)."""
        cached = self._solver_cache
        if cached is not None and cached[0] is factors:
            return cached[1]
        solver = FoldInSolver(factors, params, row_len=self.config.row_len,
                              factors_device=factors_device, device=device)
        self._solver_cache = (factors, solver)
        return solver

    def _solve_side(self, solver: FoldInSolver, vocab: np.ndarray,
                    entity_ids: List[str], side: str, split: dict,
                    deferred: Optional[Dict[str, set]] = None,
                    failed: Optional[List[str]] = None
                    ) -> Dict[str, np.ndarray]:
        """Read the entities' histories and batch-solve the non-empty
        ones. Targets the model has never seen cannot join a solve (a new
        user rating a new item): ``deferred`` collects them per entity so
        the caller can requeue the entity once they fold in. An entity
        whose history read fails lands in ``failed`` for the caller to
        requeue: it was already taken from the dirty map, and neither
        push nor pull delivers a seen event again."""
        t0 = time.perf_counter()
        try:
            history = read_entities_ratings(self.spec, entity_ids, side)
        except Exception:
            logger.exception("fold-in %s history read failed; reading the "
                             "%d entities one at a time", side,
                             len(entity_ids))
            history = {}
            for ent in entity_ids:
                try:
                    history[ent] = read_entity_ratings(self.spec, ent, side)
                except Exception:
                    logger.exception("fold-in history read failed for %s "
                                     "%r", side, ent)
                    if failed is not None:
                        failed.append(ent)
        split["read_s"] += time.perf_counter() - t0
        kept: List[str] = []
        rated: List[np.ndarray] = []
        values: List[np.ndarray] = []
        # one vocab lookup for the whole side, split per entity
        hist = [(ent, o, v) for ent, (o, v) in history.items() if len(o)]
        if not hist:
            return {}
        codes = np.split(batch_lookup(vocab, np.concatenate(
            [o for _, o, _ in hist])), np.cumsum([len(o) for _, o, _
                                                  in hist])[:-1])
        for (ent, others, vals), idx in zip(hist, codes):
            known = idx >= 0
            if deferred is not None and not known.all():
                deferred[ent] = {str(o) for o in others[~known]}
            if not known.any():
                continue
            kept.append(ent)
            rated.append(idx[known])
            values.append(vals[known])
        if not kept:
            return {}
        t0 = time.perf_counter()
        rows = solver.solve(rated, values)
        dt = time.perf_counter() - t0
        self.solves += 1
        self._m_solve.observe(dt)
        self._m_batch.observe(float(len(kept)))
        split["solves"].append(dict(solver.last_solve, side=side,
                                    seconds=dt))
        return {ent: rows[i] for i, ent in enumerate(kept)}

    def _warm_grown_catalog(self, unit) -> float:
        """Drive a catalog-growing drift's serving path through the
        warm-up ladder before the cutover (on this apply's thread, so
        the scorer rebuild never lands on a query). Returns seconds."""
        import functools

        from predictionio_tpu_torch.deploy.warm import warmup_unit

        server = self.server
        report = warmup_unit(
            unit, functools.partial(server._predict_batch_unit, unit),
            server.max_batch)
        logger.info("fold-in catalog warm-up: buckets=%s (%.3fs)",
                    report.buckets, report.seconds)
        return report.seconds

    def apply_pending(self) -> Optional[dict]:
        """One apply tick (synchronous; on the deploy executor or the
        caller's thread): pull, take up to ``max_pending`` dirty rows,
        solve, hand the engine the rows, swap. Returns the tick's split
        (see `_apply`) or None when nothing was pending or the swap
        raced a cutover, or while a canary is judged or the unit is
        evicted to warm state (``held``: the incumbent a canary is judged
        against must not drift, and a warm unit has no factors, so the
        deltas stay pending); raises (after requeueing) when the apply
        failed."""
        t_start = time.perf_counter()
        if getattr(self.server, "_canary", None) is not None \
                or self.server._unit.result is None:
            self._m_applies.inc(outcome="held")
            return None
        slo = getattr(self.server, "_slo", None)
        if slo is not None and slo.breached(exclude_kinds=("freshness",)):
            # while the serving latency/error SLO burns, a swap could make
            # things worse: the deltas stay pending until the burn clears.
            # Freshness breaches are excluded: deferring the apply is
            # exactly what would deepen one.
            self._m_applies.inc(outcome="deferred")
            logger.warning("fold-in apply deferred: serving SLO breached")
            return None
        try:
            self.pull()
        except Exception:
            logger.exception("fold-in pull scan failed (push-only tick)")
        t_pulled = time.perf_counter()
        with self._lock:
            users: Dict[str, float] = {}
            items: Dict[str, float] = {}
            budget = self.config.max_pending
            while self._dirty_users and len(users) < budget:
                uid, ts = self._dirty_users.popitem(last=False)
                users[uid] = ts
            budget -= len(users)
            while self._dirty_items and len(items) < budget:
                iid, ts = self._dirty_items.popitem(last=False)
                items[iid] = ts
            counts, self._counts = self._counts, {}
        self._update_pending_gauge()
        if not users and not items and not counts:
            self._m_applies.inc(outcome="empty")
            return None

        def requeue() -> None:
            # an apply that did not land must not LOSE its deltas
            with self._lock:
                for uid, ts in users.items():
                    self._dirty_users.setdefault(uid, ts)
                for iid, ts in items.items():
                    self._dirty_items.setdefault(iid, ts)
                for tid, c in counts.items():
                    self._counts[tid] = self._counts.get(tid, 0.0) + c
            self._update_pending_gauge()

        from predictionio_tpu_torch.deploy.warm import FoldinSwapRaced

        # re-enter the last tap's trace: this apply and its swap are
        # recorded under the ingest request's trace id
        ctx, self._last_trace = self._last_trace, None
        try:
            if ctx is not None:
                with carried(ctx, "foldin_apply", registry=self._registry,
                             attrs={"users": len(users),
                                    "items": len(items)}):
                    stats = self._apply(users, items, counts)
            else:
                stats = self._apply(users, items, counts)
        except FoldinSwapRaced as e:
            requeue()
            self._last_trace = ctx
            self._m_applies.inc(outcome="raced")
            logger.info("fold-in apply raced a cutover, deltas requeued: "
                        "%s", e)
            return None
        except Exception:
            requeue()
            self._last_trace = ctx
            self._m_applies.inc(outcome="error")
            raise
        self._m_applies.inc(outcome="applied")
        self.applies += 1
        dt = time.perf_counter() - t_start
        self.last_apply_s = dt
        self._m_apply.observe(dt)
        now = time.monotonic()
        waits = [now - ts for ts in list(users.values())
                 + list(items.values())]
        for w in waits:
            self._m_latency.observe(max(0.0, w))
        stats.update(apply=self.applies, pull_s=t_pulled - t_start,
                     apply_s=dt,
                     max_event_to_applied_s=max(waits) if waits else None)
        self.apply_log.append(stats)
        return stats

    def _apply(self, users: Dict[str, float], items: Dict[str, float],
               counts: Dict[str, float]) -> dict:
        """Solve, build and swap. The split it returns: rows folded per
        side, ``read_s`` (history reads), ``solves`` (per batched solve:
        bucketed S, K, the system's assembly, the B1 call's host ms and
        device ms), ``model_s`` (``foldin_apply``), ``register_s`` (the
        drift release), ``warm_s`` (an item fold's warm-up) and
        ``swap_s``; ``apply_pending`` adds the apply's number,
        ``pull_s``, ``apply_s`` and the longest wait from mark to
        applied."""
        server = self.server
        unit = server._unit
        algo = unit.result.algorithms[self.algo_index]
        model = unit.result.models[self.algo_index]
        fa: FoldinFactors = algo.foldin_factors(model)
        params = self.spec.als_params
        device = getattr(model, "device", None)
        split = {"read_s": 0.0, "solves": [], "model_s": 0.0,
                 "register_s": 0.0, "warm_s": 0.0, "swap_s": 0.0}

        user_rows: Dict[str, np.ndarray] = {}
        deferred: Dict[str, set] = {}
        failed_users: List[str] = []
        failed_items: List[str] = []
        if users:
            solver = self._solver_for(fa.V, params, device,
                                      factors_device=fa.V_device)
            user_rows = self._solve_side(solver, fa.item_vocab, list(users),
                                         "user", split, deferred=deferred,
                                         failed=failed_users)
        item_rows: Dict[str, np.ndarray] = {}
        if items and self.spec.fold_items:
            # items solve against the UPDATED user side: a new user's row
            # exists before their new item's raters are gathered
            uv, U2 = upsert_factor_rows(fa.user_vocab, fa.U, user_rows)
            item_solver = FoldInSolver(U2, params,
                                       row_len=self.config.row_len,
                                       device=device)
            item_rows = self._solve_side(item_solver, uv, list(items),
                                         "item", split, failed=failed_items)
            if item_rows:
                # V (and with it the cached solver) changes
                self._solver_cache = None
        if failed_users or failed_items:
            # requeue the read-failed entities with their first-seen time;
            # they did not apply in this tick
            with self._lock:
                for ent in failed_users:
                    ts = users.pop(ent, None)
                    self._dirty_users.setdefault(
                        ent, ts if ts is not None else time.monotonic())
                for ent in failed_items:
                    ts = items.pop(ent, None)
                    self._dirty_items.setdefault(
                        ent, ts if ts is not None else time.monotonic())
        split.update(users=len(user_rows), items=len(item_rows),
                     counts=len(counts))
        if not user_rows and not item_rows and not counts:
            return split

        t0 = time.perf_counter()
        new_model = algo.foldin_apply(model, self.spec, user_rows,
                                      item_rows, counts)
        new_models = list(unit.result.models)
        new_models[self.algo_index] = new_model
        t1 = time.perf_counter()
        drift = None
        if unit.foldin_of is None and unit.release is not None:
            # before the compare-and-swap: a raced swap may strand one
            # drift row (best effort), but a crash between swap and
            # registration can never hide a live drift
            drift = register_drift_release(unit.release)
        t2 = time.perf_counter()
        new_unit = server.build_foldin_unit(
            new_models, len(user_rows) + len(item_rows),
            drift_release=drift, base_unit=unit)
        if item_rows:
            # the drift grew the catalog: build its scorer now, on this
            # thread, so the first query after the swap does not
            split["warm_s"] = self._warm_grown_catalog(new_unit)
        t3 = time.perf_counter()
        server.swap_foldin_unit(new_unit, loop=self._loop,
                                expected_base=unit)
        t4 = time.perf_counter()
        split.update(model_s=t1 - t0, register_s=t2 - t1, swap_s=t4 - t3)
        self.applied_users += len(user_rows)
        self.applied_items += len(item_rows)
        if user_rows:
            self._m_rows.inc(len(user_rows), side="user")
        if item_rows:
            self._m_rows.inc(len(item_rows), side="item")
        if item_rows and deferred:
            # users whose ratings named a then-unknown item that has just
            # folded in: requeue them so the next tick completes their row
            # (only targets that folded requeue: no unknown-forever loop)
            folded = set(item_rows)
            now = time.monotonic()
            with self._lock:
                for uid, missing in deferred.items():
                    if missing & folded:
                        self._dirty_users.setdefault(uid, now)
        logger.info("fold-in applied %d user / %d item rows (%d count "
                    "deltas) onto instance %s", len(user_rows),
                    len(item_rows), len(counts), unit.instance.id)
        return split

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Arm the push tap and, on a running event loop, the apply
        task. Callers without a loop drive `apply_pending` themselves."""
        from predictionio_tpu_torch.data.write_buffer import add_flush_tap

        add_flush_tap(self.tap)
        self._kick = threading.Event()
        try:
            import asyncio

            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            self._loop = None
            return
        self._task = self._loop.create_task(self._run())

    async def _run(self):
        import asyncio

        interval = self.config.apply_interval_s
        loop = self._loop
        while True:
            if not self._kick.is_set():
                # sleep the interval, waking early on a kick (set from the
                # ingest writer thread, so it is polled)
                slept = 0.0
                step = min(interval, max(0.05, interval / 8.0))
                while slept < interval and not self._kick.is_set():
                    await asyncio.sleep(step)
                    slept += step
            self._kick.clear()
            try:
                await loop.run_in_executor(self.server._deploy_executor,
                                           self.apply_pending)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("fold-in apply tick failed")

    async def aclose(self) -> None:
        import asyncio

        self.stop_tap()
        task = self._task
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._task = None

    def stop_tap(self) -> None:
        from predictionio_tpu_torch.data.write_buffer import remove_flush_tap

        remove_flush_tap(self.tap)

    def status_dict(self) -> dict:
        return {
            "enabled": True,
            "applyIntervalS": self.config.apply_interval_s,
            "maxPending": self.config.max_pending,
            "pendingRows": self.pending_rows(),
            "applies": self.applies,
            "appliedUserRows": self.applied_users,
            "appliedItemRows": self.applied_items,
            "solveCalls": self.solves,
            "outcomes": dict(self.outcomes),
            "lastApplySeconds": self.last_apply_s,
            "recentApplies": list(self.apply_log),
        }
