"""The vectorized ``$set``/``$unset``/``$delete`` fold over the event
store's numpy columns (the reference's
``data/columnar.aggregate_properties_table``, over the dict of columns
``SqliteEvents.find_columns`` returns where the reference reads a
pyarrow table: the machine with the card has no pyarrow).
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Dict, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import AGGREGATOR_EVENT_NAMES
from predictionio_tpu_torch.data.bimap import assign_indices
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import UTC

#: the columns the fold reads (``find_columns`` names)
AGGREGATE_COLUMNS = ("event", "entity_id", "properties", "event_time_ms")


def aggregate_properties_columns(cols: Dict[str, np.ndarray],
                                 required: Optional[Sequence[str]] = None
                                 ) -> Dict[str, PropertyMap]:
    """``{entity_id: PropertyMap}`` of the special events in ``cols``
    (``AGGREGATE_COLUMNS``, rows in any order), with the row fold's
    semantics (``data/aggregator``) computed by sort and last-wins
    segment operations on flat arrays:

      1. one stable lexsort puts every entity's special events in time
         order (ties keep scan order, like the row fold's stable sort);
      2. ``$delete`` precedence is a per-entity max-scan: rows at or
         before the segment's last delete never contribute fields;
      3. fields resolve last-wins per (entity, key): the surviving rows'
         parsed keys, sorted by (entity, key, position), each group's
         final op kept, the key kept iff that op is a ``$set``;
      4. first/last updated are the segment's time extrema over ALL its
         special rows (pre-delete rows still advance the clock).

    ``required`` keeps only entities carrying every named field
    (PEventStore.aggregateProperties ``required``)."""
    events = np.asarray(cols["event"], dtype=object)
    if not len(events):
        return {}
    special = np.isin(events, np.asarray(AGGREGATOR_EVENT_NAMES,
                                         dtype=object))
    entity_ids = np.asarray(cols["entity_id"], dtype=object)[special]
    times = np.asarray(cols["event_time_ms"], np.int64)[special]
    props = np.asarray(cols["properties"], dtype=object)[special]
    events = events[special]
    if not len(events):
        return {}

    vocab, codes = assign_indices(entity_ids)
    n = len(codes)
    # stable (entity, time) order; the trailing arange keeps scan order
    # for equal timestamps (sorted() stability in the row fold)
    order = np.lexsort((np.arange(n), times, codes))
    codes_s, times_s = codes[order], times[order]
    events_s = events[order]

    starts = np.flatnonzero(np.r_[True, codes_s[1:] != codes_s[:-1]])
    seg_of = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts, n]))
    seg_entity = vocab[codes_s[starts]]
    first_ms = times_s[starts]
    last_ms = times_s[np.r_[starts[1:] - 1, n - 1]]

    # rows at or before each segment's last $delete are dead
    pos = np.arange(n)
    is_delete = events_s == "$delete"
    last_delete = np.maximum.reduceat(np.where(is_delete, pos, -1), starts)
    alive = pos > last_delete[seg_of]

    is_set = events_s == "$set"
    live_seg = np.zeros(len(starts), dtype=bool)
    live_seg[seg_of[alive & is_set]] = True

    # flatten surviving rows into (segment, key, position, is_set, value)
    surv = np.flatnonzero(alive & (is_set | (events_s == "$unset")))
    f_seg, f_key, f_pos, f_set, f_val = [], [], [], [], []
    for s_i in surv:
        raw = props[order[s_i]]
        fields = json.loads(raw) if raw else {}
        seg = seg_of[s_i]
        setop = bool(is_set[s_i])
        for k, v in fields.items():
            f_seg.append(seg)
            f_key.append(k)
            f_pos.append(s_i)
            f_set.append(setop)
            f_val.append(v)

    out_fields = {int(s): {} for s in np.flatnonzero(live_seg)}
    if f_seg:
        f_seg = np.asarray(f_seg, dtype=np.int64)
        f_pos = np.asarray(f_pos, dtype=np.int64)
        f_set = np.asarray(f_set, dtype=bool)
        _, key_codes = assign_indices(np.asarray(f_key, dtype=object))
        # last-wins per (segment, key): sort and keep each group's tail
        forder = np.lexsort((f_pos, key_codes, f_seg))
        gs, gk = f_seg[forder], key_codes[forder]
        is_last = np.r_[(gs[1:] != gs[:-1]) | (gk[1:] != gk[:-1]), True]
        winners = forder[is_last]
        for w in winners[f_set[winners]]:
            seg = int(f_seg[w])
            if seg in out_fields:
                out_fields[seg][f_key[w]] = f_val[w]

    def when(ms: int) -> _dt.datetime:
        return _dt.datetime.fromtimestamp(ms / 1000, tz=UTC)

    req = list(required) if required else None
    out = {}
    for seg, fields in out_fields.items():
        if req and not all(r in fields for r in req):
            continue
        out[str(seg_entity[seg])] = PropertyMap(
            fields, when(int(first_ms[seg])), when(int(last_ms[seg])))
    return out
