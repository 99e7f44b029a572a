"""The port's snapshot-digest scan cache and ``ingest_*`` instrumentation
(``data/ingest.py``) against the JAX package's, on the CPU.

Both packages read one sqlite file that the reference writes. The same
sequence of reads (an unchanged store twice, then one more event, then
the cache switched off by ``PIO_INGEST_CACHE=0``) must give the same
hit/miss counts and rows on each package's process registry, under the
reference's counter and span names, and the same rows: a hit returns
what the rescan would.
"""

import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.data.ingest as ref_ingest
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.data.ingest as port_ingest
from predictionio_tpu.data import DataMap as RefDataMap, Event as RefEvent
from predictionio_tpu.data.eventstore import (
    EventStoreClient as RefEventStoreClient,
)
from predictionio_tpu.obs.registry import (
    default_registry as ref_default_registry,
)
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu_torch.data.eventstore import EventStoreClient
from predictionio_tpu_torch.obs.registry import default_registry
from predictionio_tpu_torch.storage.registry import Storage as PortStorage

APP = "TorchIngestApp"
COUNTERS = ("pio_ingest_cache_hits_total", "pio_ingest_cache_misses_total",
            "pio_ingest_rows_total")
SPANS = ("ingest_scan", "ingest_aggregate", "ingest_intern",
         "ingest_assemble")


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _reset():
    RefStorage.reset()
    PortStorage.reset()
    ref_eventstore.clear_cache()
    port_eventstore.clear_cache()


def _rate(u, i, r):
    return RefEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=RefDataMap({"rating": float(r)}))


def _user(u):
    return RefEvent(event="$set", entity_type="user", entity_id=f"u{u}",
                    properties=RefDataMap({"plan": float(u % 2),
                                           "attr0": float(u)}))


@pytest.fixture()
def store(tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_INGEST_CACHE", raising=False)
    _reset()
    RefStorage.configure(_config(tmp_path / "ingest.db"))
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    events = RefStorage.get_events()
    events.init_channel(app_id)
    events.insert_batch([_user(u) for u in range(12)]
                        + [_rate(u, (u * 3 + j) % 7, 1 + (u + j) % 5)
                           for u in range(12) for j in range(3)], app_id)
    PortStorage.configure(_config(tmp_path / "ingest.db"))

    def append(evs):
        RefStorage.get_events().insert_batch(evs, app_id)

    yield append
    _reset()


def _counts(registry):
    out = {}
    for name in COUNTERS:
        metric = registry.get(name)
        out[name] = (metric.value(app=APP)
                     if metric is not None and metric.contains(app=APP)
                     else 0.0)
    return out


def _delta(after, before):
    return {k: after[k] - before[k] for k in COUNTERS}


def _port_reads():
    cols = EventStoreClient.training_columns(
        APP, entity_type="user", event_names=["rate"],
        target_entity_type="item",
        columns=("entity_id", "target_entity_id"))
    props = port_ingest.aggregate_scan(APP, "user",
                                       required=["plan", "attr0"])
    return cols, props


def _ref_reads():
    scan = ref_ingest.training_scan(
        APP, entity_type="user", event_names=["rate"],
        target_entity_type="item")
    props = ref_ingest.aggregate_scan(APP, "user",
                                      required=["plan", "attr0"])
    return scan.table, props


def _sequence(reads, registry, append, monkeypatch):
    """The counter deltas of: two reads of an unchanged store, a read
    after one more event, a read with the cache off."""
    steps = []
    before = _counts(registry)
    reads()
    steps.append(_delta(_counts(registry), before))
    before = _counts(registry)
    reads()
    steps.append(_delta(_counts(registry), before))
    append([_rate(1, 6, 2), _user(40)])
    before = _counts(registry)
    reads()
    steps.append(_delta(_counts(registry), before))
    monkeypatch.setenv("PIO_INGEST_CACHE", "0")
    before = _counts(registry)
    reads()
    steps.append(_delta(_counts(registry), before))
    monkeypatch.delenv("PIO_INGEST_CACHE")
    return steps


def test_hits_misses_and_rows_match_reference(store, monkeypatch):
    """Each package through the same four steps; the reference's run
    starts on the store as the port's left it (one rate event more)."""
    port_steps = _sequence(_port_reads, default_registry(), store,
                           monkeypatch)
    ref_steps = _sequence(_ref_reads, ref_default_registry(), store,
                          monkeypatch)

    def hits_misses(steps):
        return [(s["pio_ingest_cache_hits_total"],
                 s["pio_ingest_cache_misses_total"]) for s in steps]

    assert hits_misses(port_steps) == hits_misses(ref_steps) == \
        [(0, 2), (2, 0), (0, 2), (0, 0)]
    # rows the training scan delivered (the property fold counts none)
    assert [s["pio_ingest_rows_total"] for s in port_steps] == [36, 0, 37, 37]
    assert [s["pio_ingest_rows_total"] for s in ref_steps] == [37, 0, 38, 38]


def test_spans_carry_the_reference_names(store):
    from predictionio_tpu_torch.data.ingest import pair_counts

    cols, _ = _port_reads()
    pair_counts(cols["entity_id"], cols["target_entity_id"])
    hist = default_registry().get("pio_span_duration_seconds")
    seen = {labels["span"] for labels, _ in hist.samples()}
    assert set(SPANS) <= seen
    ref_scan, _ = _ref_reads()
    users = np.asarray(ref_scan.column("entity_id").to_pylist(), object)
    items = np.asarray(ref_scan.column("target_entity_id").to_pylist(),
                       object)
    ref_ingest.pair_counts(users, items)
    ref_hist = ref_default_registry().get("pio_span_duration_seconds")
    ref_seen = {labels["span"] for labels, _ in ref_hist.samples()}
    assert set(SPANS) <= ref_seen


def test_a_hit_returns_what_a_rescan_reads(store):
    cols, props = _port_reads()
    hit_cols, hit_props = _port_reads()
    assert hit_cols is not cols and hit_props is not props
    for k in cols:
        assert hit_cols[k] is cols[k]          # the cached arrays
        assert not cols[k].flags.writeable
        with pytest.raises(ValueError):
            cols[k][0] = "x"
    fresh = EventStoreClient.training_columns(
        APP, entity_type="user", event_names=["rate"],
        target_entity_type="item",
        columns=("entity_id", "target_entity_id"), cache=False)
    for k in cols:
        np.testing.assert_array_equal(fresh[k], cols[k])
    fresh_props = port_ingest.aggregate_scan(APP, "user",
                                             required=["plan", "attr0"],
                                             cache=False)
    assert {k: v.fields for k, v in fresh_props.items()} == \
        {k: v.fields for k, v in props.items()}
    # the same answer as the reference's read of the store
    ref_table, ref_props = _ref_reads()
    assert sorted(ref_table.column("entity_id").to_pylist()) == \
        sorted(cols["entity_id"].tolist())
    assert set(ref_props) == set(props)


def test_reconfiguring_the_store_drops_the_cache(store, tmp_path):
    _port_reads()
    assert port_ingest._scan_cache
    PortStorage.configure(_config(tmp_path / "ingest.db"))
    assert not port_ingest._scan_cache
    _port_reads()
    port_eventstore.clear_cache()
    assert not port_ingest._scan_cache


def test_the_cache_holds_at_most_cache_max_reads(store):
    for n in range(port_ingest._CACHE_MAX + 3):
        EventStoreClient.training_columns(
            APP, entity_type="user", event_names=["rate"],
            columns=("entity_id",), limit=n + 1)
    assert len(port_ingest._scan_cache) == port_ingest._CACHE_MAX
    assert port_ingest._CACHE_MAX == ref_ingest._CACHE_MAX


def test_digest_of_the_client_tracks_inserts(store):
    d0 = EventStoreClient.snapshot_digest(APP)
    assert d0 == EventStoreClient.snapshot_digest(APP)
    store([_user(99)])
    assert EventStoreClient.snapshot_digest(APP) != d0
    assert RefEventStoreClient.snapshot_digest(APP) is not None
