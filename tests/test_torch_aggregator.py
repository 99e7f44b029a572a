"""Entity properties from ``$set``/``$unset``/``$delete`` (the port's
``data/aggregator.py``, ``data/columnar.aggregate_properties_columns``,
``EventStore.aggregate_properties`` and ``EventStoreClient``), held
against the JAX package's ``aggregate_properties`` on ONE sqlite store
that the reference writes and both packages read.

Random special-event sequences per entity, made from a seed with numpy:
``$set``/``$unset``/``$delete`` in every order, timestamps drawn from a
small set so that equal timestamps are common (scan order decides
them), non-special events mixed in, ``required`` on and off. Fields and
first/last updated times must be equal (exact: the same integers and
strings, the same epoch milliseconds). The port's row fold over the
same events agrees with its vectorized fold.
"""

import datetime as dt

import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu_torch.data.eventstore as port_eventstore
from predictionio_tpu.data import DataMap as RefDataMap, Event as RefEvent
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu_torch.data.aggregator import (
    aggregate_properties as port_row_fold,
)
from predictionio_tpu_torch.data.ingest import aggregate_scan
from predictionio_tpu_torch.storage.registry import Storage as PortStorage

APP = "TorchAggApp"
BASE = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)
KEYS = ("a", "b", "c", "d")


def _config(path):
    return {
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                         for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    }


@pytest.fixture()
def stores(tmp_path):
    def reset():
        RefStorage.reset()
        PortStorage.reset()
        ref_eventstore.clear_cache()
        port_eventstore.clear_cache()

    reset()
    yield tmp_path
    reset()


def _sequences(seed, n_entities=40):
    """(entity type, entity id, event, properties, seconds) rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for e in range(n_entities):
        etype = "user" if e % 3 else "item"
        for _ in range(int(rng.integers(1, 8))):
            kind = rng.choice(["$set", "$set", "$unset", "$delete", "view"])
            keys = rng.choice(KEYS, size=int(rng.integers(1, 3)),
                              replace=False)
            if kind == "$set":
                props = {str(k): int(rng.integers(0, 5)) for k in keys}
            elif kind == "$unset":
                props = {str(k): None for k in keys}
            else:
                props = {}
            # four distinct timestamps: equal times are the rule
            rows.append((etype, f"e{e}", str(kind), props,
                         int(rng.integers(0, 4))))
    return rows


def _write(path, rows):
    RefStorage.configure(_config(path))
    ref_eventstore.clear_cache()
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    store = RefStorage.get_events()
    store.init_channel(app_id)
    store.insert_batch([
        RefEvent(event=kind, entity_type=etype, entity_id=eid,
                 target_entity_type="item" if kind == "view" else None,
                 target_entity_id="x" if kind == "view" else None,
                 properties=RefDataMap(props),
                 event_time=BASE + dt.timedelta(seconds=s))
        for etype, eid, kind, props, s in rows], app_id)
    PortStorage.configure(_config(path))
    port_eventstore.clear_cache()


def _same(port_out, ref_out):
    assert sorted(port_out) == sorted(ref_out)
    for eid, want in ref_out.items():
        got = port_out[eid]
        assert got.fields == want.fields, eid
        assert got.first_updated == want.first_updated, eid
        assert got.last_updated == want.last_updated, eid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("entity_type", ["user", "item"])
def test_fold_matches_reference(stores, seed, entity_type):
    _write(stores / "agg.db", _sequences(seed))
    want = ref_eventstore.EventStoreClient.aggregate_properties(
        APP, entity_type)
    got = port_eventstore.EventStoreClient.aggregate_properties(
        APP, entity_type)
    assert want, "the sequences left no live entity"
    _same(got, want)
    _same(aggregate_scan(APP, entity_type), want)


@pytest.mark.parametrize("required", [["a"], ["a", "b"], ["d", "c"]])
def test_required_matches_reference(stores, required):
    _write(stores / "req.db", _sequences(5, n_entities=60))
    want = ref_eventstore.EventStoreClient.aggregate_properties(
        APP, "user", required=required)
    got = port_eventstore.EventStoreClient.aggregate_properties(
        APP, "user", required=required)
    _same(got, want)
    assert all(all(r in pm.fields for r in required)
               for pm in got.values())


@pytest.mark.parametrize("seed", [0, 7])
def test_row_fold_matches_columnar_fold(stores, seed):
    _write(stores / "rows.db", _sequences(seed))
    events = list(port_eventstore.EventStoreClient.find(
        APP, entity_type="user"))
    _same(port_row_fold(events),
          port_eventstore.EventStoreClient.aggregate_properties(
              APP, "user"))


@pytest.mark.parametrize("order,want", [
    (["$set", "$unset", "$set"], {"a": 2, "b": 1}),
    (["$set", "$delete"], None),
    (["$delete", "$set"], {"a": 2, "b": 1}),
    (["$set", "$delete", "$unset"], None),
    (["$unset", "$set"], {"a": 2, "b": 1}),
])
def test_orders_at_equal_timestamps(stores, order, want):
    """At one timestamp, scan order decides: a $set, $unset or $delete
    written later wins, in both packages."""
    props = {"$set": {"a": 2, "b": 1}, "$unset": {"a": None},
             "$delete": {}}
    rows = [("user", "u", kind, props[kind], 0) for kind in order]
    _write(stores / "ties.db", rows)
    ref = ref_eventstore.EventStoreClient.aggregate_properties(APP, "user")
    got = port_eventstore.EventStoreClient.aggregate_properties(APP, "user")
    _same(got, ref)
    assert (got["u"].fields if "u" in got else None) == (
        ref["u"].fields if "u" in ref else None)
    if want is not None and order[-1] == "$set":
        assert got["u"].fields == want
