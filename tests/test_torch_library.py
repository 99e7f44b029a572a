"""The port's small library modules held against the JAX package's on the
CPU: ``core/self_cleaning`` (``clean_events`` on seeded events, and
``clean_persisted_events`` on sqlite and on evlog stores leaving the
reference's event bag), ``data/entity_map.EntityMap`` and
``data/bimap.BiMap`` (the reference's ``tests/test_views.py`` and
``tests/test_ingest.py::test_entity_map_from_columnar`` cases),
``utils/config`` (``pio_home``, ``pio_env_vars``), ``utils/cleanup`` and
``utils/logging_util``."""

import collections
import datetime as dt
import logging

import numpy as np
import pytest

import predictionio_tpu.core.self_cleaning as ref_sc
import predictionio_tpu.utils.cleanup as ref_cleanup
import predictionio_tpu.utils.config as ref_config
import predictionio_tpu_torch.core.self_cleaning as sc
from predictionio_tpu.data.bimap import BiMap as RefBiMap
from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.entity_map import EntityMap as RefEntityMap
from predictionio_tpu.data.event import Event as RefEvent
from predictionio_tpu.storage import App as RefApp
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.entity_map import EntityMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils import cleanup, config, logging_util
from predictionio_tpu_torch.utils import server_config

UTC = dt.timezone.utc


def t(days):
    return dt.datetime(2026, 1, 1, tzinfo=UTC) + dt.timedelta(days=days)


# -- self-cleaning --------------------------------------------------------------

def _seeded(n=160, seed=0, base=None):
    """(port events, reference events) of one seeded law: $set/$unset/
    $delete chains over a few users, views, exact duplicates, and times
    spread over 40 days before ``base``."""
    base = base or t(40)
    rng = np.random.default_rng(seed)
    rows = []
    for j in range(n):
        kind = int(rng.integers(0, 6))
        when = base - dt.timedelta(hours=int(rng.integers(0, 960)))
        user = f"u{rng.integers(0, 6)}"
        if kind <= 1:
            props = {f"p{rng.integers(0, 3)}": int(rng.integers(0, 9))}
            rows.append(("$set", user, None, props, when))
        elif kind == 2:
            rows.append(("$unset", user, None,
                         {f"p{rng.integers(0, 3)}": None}, when))
        elif kind == 3 and rng.random() < 0.2:
            rows.append(("$delete", user, None, {}, when))
        else:
            rows.append(("view", user, f"i{rng.integers(0, 4)}", {}, when))
        if rng.random() < 0.15:
            rows.append(rows[-1])            # an exact duplicate
    port, ref = [], []
    for name, user, item, props, when in rows:
        kw = dict(event=name, entity_type="user", entity_id=user,
                  target_entity_type="item" if item else None,
                  target_entity_id=item, event_time=when,
                  creation_time=when)
        port.append(Event(properties=DataMap(props), **kw))
        ref.append(RefEvent(properties=RefDataMap(props), **kw))
    return port, ref


def _bag(events):
    return collections.Counter(
        (e.event, e.entity_type, e.entity_id, e.target_entity_type,
         e.target_entity_id, e.properties.to_json(),
         e.event_time.isoformat()) for e in events)


WINDOWS = [dict(duration="10 days"), dict(duration="3 weeks",
                                          compress_properties=True),
           dict(remove_duplicates=True),
           dict(duration="720 hours", compress_properties=True,
                remove_duplicates=True),
           dict(compress_properties=True), dict()]


@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_clean_events_equals_reference(window):
    port, ref = _seeded()
    got = sc.clean_events(port, sc.EventWindow(**window), now=t(40))
    want = ref_sc.clean_events(ref, ref_sc.EventWindow(**window), now=t(40))
    assert [e.to_json() for e in got] == [e.to_json() for e in want]


def test_event_window_cutoff():
    w = sc.EventWindow(duration="3 days")
    assert w.cutoff(t(10)) == t(7)
    assert sc.EventWindow().cutoff(t(10)) is None
    for d in ("1 week", "90 minutes", "30 seconds", "2 day", "5"):
        assert sc.EventWindow(duration=d).cutoff(t(10)) == \
            ref_sc.EventWindow(duration=d).cutoff(t(10))
    with pytest.raises(ValueError):
        sc.EventWindow(duration="5 fortnights").cutoff(t(10))


def test_clean_events_window_and_compress():
    events = [
        Event(event="$set", entity_type="user", entity_id="u1",
              properties=DataMap({"a": 1, "b": 2}), event_time=t(0)),
        Event(event="$set", entity_type="user", entity_id="u1",
              properties=DataMap({"a": 9}), event_time=t(5)),
        Event(event="$unset", entity_type="user", entity_id="u1",
              properties=DataMap({"b": None}), event_time=t(6)),
        Event(event="view", entity_type="user", entity_id="u1",
              target_entity_type="item", target_entity_id="i1",
              event_time=t(6)),
    ]
    out = sc.clean_events(events, sc.EventWindow(
        duration="30 days", compress_properties=True), now=t(7))
    sets = [e for e in out if e.event == "$set"]
    assert len(sets) == 1 and sets[0].properties.fields == {"a": 9}
    assert len([e for e in out if e.event == "view"]) == 1
    out = sc.clean_events(events, sc.EventWindow(duration="3 days"),
                          now=t(7))
    assert all(e.event_time >= t(4) for e in out)


def _store_config(tmp, kind):
    ev = ({"TYPE": "evlog", "PATH": str(tmp / "evlog"), "CODEC": "python"}
          if kind == "evlog" else
          {"TYPE": "sqlite", "PATH": str(tmp / "ev.db")})
    return {"sources": {"META": {"TYPE": "sqlite",
                                 "PATH": str(tmp / "meta.db")},
                        "EV": ev},
            "repositories": {
                "METADATA": {"NAME": "pio", "SOURCE": "META"},
                "EVENTDATA": {"NAME": "pio", "SOURCE": "EV"},
                "MODELDATA": {"NAME": "pio", "SOURCE": "META"}}}


@pytest.fixture()
def stores():
    from predictionio_tpu.data import eventstore as ref_eventstore
    from predictionio_tpu_torch.data import eventstore

    yield
    Storage.reset()
    RefStorage.reset()
    eventstore.clear_cache()
    ref_eventstore.clear_cache()


@pytest.mark.parametrize("kind", ["sqlite", "evlog"])
@pytest.mark.parametrize("window", WINDOWS[1:4], ids=str)
def test_clean_persisted_events_leaves_the_references_bag(
        tmp_path, stores, kind, window):
    """Each package rewrites a store of its own holding the same events;
    both keep the same bag. The window counts from the real clock, so the
    events sit just before it."""
    from predictionio_tpu.data import eventstore as ref_eventstore
    from predictionio_tpu_torch.data import eventstore

    now = dt.datetime.now(tz=UTC)
    port_ev, ref_ev = _seeded(base=now)
    Storage.configure(_store_config(tmp_path / "port", kind))
    RefStorage.configure(_store_config(tmp_path / "ref", kind))
    eventstore.clear_cache()
    ref_eventstore.clear_cache()
    pid = Storage.get_meta_data_apps().insert(App(id=0, name="Clean"))
    rid = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name="Clean"))
    Storage.get_events().init_channel(pid)
    RefStorage.get_events().init_channel(rid)
    Storage.get_events().insert_batch(port_ev, pid)
    RefStorage.get_events().insert_batch(ref_ev, rid)

    class PortDS(sc.SelfCleaningDataSource):
        app_name = "Clean"
        event_window = sc.EventWindow(**window)

    class RefDS(ref_sc.SelfCleaningDataSource):
        app_name = "Clean"
        event_window = ref_sc.EventWindow(**window)

    n = PortDS().clean_persisted_events()
    assert n == RefDS().clean_persisted_events() > 0
    left = list(Storage.get_events().find(pid))
    assert len(left) == n
    assert _bag(left) == _bag(RefStorage.get_events().find(rid))
    # the cleaned events are stored under new ids: none of the old ones
    old = {e.event_id for e in port_ev}
    assert not old & {e.event_id for e in left}
    # the read-only read applies the same rules to what is left
    assert _bag(PortDS().get_cleaned_events()) == _bag(sc.clean_events(
        left, sc.EventWindow(**window)))


def test_no_window_cleans_nothing(tmp_path, stores):
    Storage.configure(_store_config(tmp_path, "evlog"))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Keep"))
    Storage.get_events().init_channel(app_id)
    port_ev, _ = _seeded(n=20)
    Storage.get_events().insert_batch(port_ev, app_id)

    class DS(sc.SelfCleaningDataSource):
        app_name = "Keep"

    assert DS().clean_persisted_events() == 0
    assert len(DS().get_cleaned_events()) == len(port_ev)


# -- EntityMap and BiMap --------------------------------------------------------

def test_entity_map_ids_and_data():
    em = EntityMap({"b": 20, "a": 10, "c": 30})
    assert len(em) == 3
    assert em.entity_int_id("a") == 0
    assert em.entity_int_id("c") == 2
    assert em.entity_id_of(1) == "b"
    assert em["b"] == 20
    assert em.data_by_int_id(2) == 30
    assert "a" in em and "z" not in em
    assert em.get("z", 5) == 5 and list(em) == ["b", "a", "c"]


def test_entity_map_map_values_keeps_id_space():
    em = EntityMap({"x": 1, "y": 2})
    doubled = em.map_values(lambda v: v * 2)
    assert doubled["y"] == 4
    assert doubled.entity_int_id("x") == em.entity_int_id("x")
    assert doubled.id_map is em.id_map


def test_entity_map_rows_in_int_id_order():
    em = EntityMap({"m": "M", "k": "K"})
    assert list(em.to_rows()) == [("k", 0, "K"), ("m", 1, "M")]


def test_entity_map_from_columnar():
    ids = ["z", "a", "m"]
    payloads = [1, 2, 3]
    em = EntityMap.from_columnar(ids, payloads)
    ref = EntityMap(dict(zip(ids, payloads)))
    assert em.id_map == ref.id_map
    assert dict(em.items()) == dict(ref.items())
    assert em.entity_int_id("a") == 0 and em.entity_id_of(2) == "z"


def test_entity_map_rejects_a_mismatched_id_map():
    with pytest.raises(ValueError, match="1 data-only, 1 map-only"):
        EntityMap({"a": 1, "b": 2}, BiMap({"a": 0, "c": 1}))


def test_entity_map_and_bimap_equal_the_reference():
    rng = np.random.default_rng(5)
    ids = [f"e{rng.integers(0, 500)}" for _ in range(400)]
    payloads = rng.normal(size=400).tolist()
    em = EntityMap.from_columnar(np.asarray(ids, dtype=object), payloads)
    ref = RefEntityMap.from_columnar(np.asarray(ids, dtype=object),
                                     payloads)
    assert dict(em.id_map.items()) == dict(ref.id_map.items())
    assert list(em.to_rows()) == list(ref.to_rows())
    assert repr(em) == repr(ref)
    keys = [f"k{j}" for j in rng.permutation(50)]
    for ctor in ("string_int", "string_long", "string_double"):
        assert getattr(BiMap, ctor)(keys).to_map() == \
            getattr(RefBiMap, ctor)(keys).to_map()
    b = BiMap.string_int(keys)
    assert b.inverse().inverse() == b and b.inverse()[0] == "k0"
    assert b.take(3).to_map() == RefBiMap.string_int(keys).take(3).to_map()
    assert b.get_opt("nope") is None and b.contains("k1")
    with pytest.raises(ValueError, match="unique"):
        BiMap({"a": 1, "b": 1})


# -- utils ------------------------------------------------------------------------

def test_pio_home_and_env_vars(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_X_TYPE", "evlog")
    monkeypatch.setenv("NOT_PIO", "1")
    assert config.pio_home() == ref_config.pio_home() == str(tmp_path)
    assert server_config.pio_home is config.pio_home
    assert config.pio_env_vars() == ref_config.pio_env_vars()
    assert config.pio_env_vars()["PIO_STORAGE_SOURCES_X_TYPE"] == "evlog"
    assert "NOT_PIO" not in config.pio_env_vars()
    monkeypatch.delenv("PIO_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "h"))
    assert config.pio_home() == ref_config.pio_home() == str(
        tmp_path / "h" / ".pio_tpu")


@pytest.mark.parametrize("mod", [cleanup, ref_cleanup],
                         ids=["port", "reference"])
def test_cleanup_runs_in_order_clears_and_survives_a_failure(mod, caplog):
    mod.clear()
    calls = []

    def boom():
        raise RuntimeError("x")

    mod.add(lambda: calls.append(1))
    mod.add(boom)
    mod.add(lambda: calls.append(2))
    with caplog.at_level(logging.ERROR, logger="pio.cleanup"):
        mod.run()
    assert calls == [1, 2]
    assert "cleanup callback" in caplog.text
    mod.run()        # cleared: no second run
    assert calls == [1, 2]
    mod.add(lambda: calls.append(3))
    mod.clear()
    mod.run()
    assert calls == [1, 2]


def test_configure_logging_format_and_level(monkeypatch):
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", [])
    monkeypatch.setattr(root, "level", root.level)
    logging_util.configure_logging(verbose=True)
    assert root.level == logging.DEBUG
    assert root.handlers[0].formatter._fmt == \
        "[%(levelname)s] [%(name)s] %(message)s"
    monkeypatch.setattr(root, "handlers", [])
    logging_util.configure_logging()
    assert root.level == logging.INFO
