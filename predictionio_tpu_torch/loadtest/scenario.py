"""Declarative storm scenarios (port of the reference's
``loadtest/scenario.py``): one JSON file describes the whole run.

A scenario names the population (size, catalog, skew), the arrival
curve (base rate, diurnal amplitude/period), the traffic mix
(events / queries / feedback fractions), the fleet shape (replicas,
partitions, backend), and a timeline of injected **incidents** — the
chaos the run must survive with its invariants intact:

* ``kill_replica``    — stop a replica's server mid-storm (the router
  must eject it with backed-off probes and retry its queries
  elsewhere); ``restartAfterS`` restarts it on the SAME port and the
  router must re-admit it.
* ``kill_compaction`` — arm a storage kill point and run a partition
  compaction so it crashes mid-rewrite; recovery must roll forward
  with zero lost or duplicated events (the post-run audit proves it).
* ``burn_slo``        — force replica SLO burn (probes see
  ``breached: true``) for ``durationS`` seconds.
* ``degrade_quality`` — make served slates deliberately stale/bad so
  the orchestrator's data-driven triggers have a reason to retrain.
* ``retrain``         — force an orchestrator cycle at ``atS`` (the
  deterministic way to assert retrain-and-promote completes mid-run).

Validation is strict and path-labelled: unknown keys, unknown incident
kinds, wrong types, out-of-range times all raise :class:`ScenarioError`
naming the offending path — a scenario file that parses is a scenario
file that runs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

__all__ = ["ScenarioError", "Incident", "TenantMix", "Scenario"]

INCIDENT_KINDS = ("kill_replica", "kill_compaction", "burn_slo",
                  "degrade_quality", "retrain")


class ScenarioError(ValueError):
    """A malformed scenario file; the message names the JSON path."""


def _expect(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise ScenarioError(f"{path}: {msg}")


def _num(d: dict, key: str, path: str, default=None, lo=None, hi=None):
    v = d.get(key, default)
    _expect(isinstance(v, (int, float)) and not isinstance(v, bool),
            f"{path}.{key}", f"expected a number, got {v!r}")
    if lo is not None:
        _expect(v >= lo, f"{path}.{key}", f"must be >= {lo}, got {v!r}")
    if hi is not None:
        _expect(v <= hi, f"{path}.{key}", f"must be <= {hi}, got {v!r}")
    return v


def _int(d: dict, key: str, path: str, default=None, lo=None, hi=None) -> int:
    v = _num(d, key, path, default=default, lo=lo, hi=hi)
    _expect(float(v).is_integer(), f"{path}.{key}",
            f"expected an integer, got {v!r}")
    return int(v)


def _reject_unknown(d: dict, allowed: set, path: str) -> None:
    unknown = set(d) - allowed
    _expect(not unknown, path,
            f"unknown key(s) {sorted(unknown)} (allowed: {sorted(allowed)})")


@dataclasses.dataclass
class Incident:
    """One timeline entry. ``target`` is the replica rank for
    ``kill_replica``; ``restart_after_s`` restarts it that many seconds
    after the kill (0 = never restart)."""

    kind: str
    at_s: float
    target: int = 0
    restart_after_s: float = 0.0
    duration_s: float = 0.0
    tenant: str = ""                  #: burn_slo only: burn ONE tenant

    _ALLOWED = {"kind", "atS", "target", "restartAfterS", "durationS",
                "tenant"}

    @classmethod
    def from_dict(cls, d: dict, path: str, duration_s: float) -> "Incident":
        _expect(isinstance(d, dict), path, f"expected an object, got {d!r}")
        _reject_unknown(d, cls._ALLOWED, path)
        kind = d.get("kind")
        _expect(kind in INCIDENT_KINDS, f"{path}.kind",
                f"unknown incident kind {kind!r} "
                f"(one of {list(INCIDENT_KINDS)})")
        at_s = _num(d, "atS", path, lo=0.0)
        _expect(at_s <= duration_s, f"{path}.atS",
                f"incident at {at_s}s is past the scenario's "
                f"{duration_s}s duration")
        tenant = d.get("tenant", "")
        _expect(isinstance(tenant, str), f"{path}.tenant",
                f"expected a string, got {tenant!r}")
        inc = cls(
            kind=kind, at_s=float(at_s),
            target=_int(d, "target", path, default=0, lo=0),
            restart_after_s=float(
                _num(d, "restartAfterS", path, default=0.0, lo=0.0)),
            duration_s=float(
                _num(d, "durationS", path, default=0.0, lo=0.0)),
            tenant=tenant)
        if kind != "kill_replica":
            _expect("restartAfterS" not in d, f"{path}.restartAfterS",
                    f"only kill_replica incidents restart, not {kind}")
        if kind != "burn_slo":
            _expect("tenant" not in d, f"{path}.tenant",
                    f"only burn_slo incidents target a tenant, not {kind}")
        return inc

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "atS": self.at_s}
        if self.target:
            d["target"] = self.target
        if self.restart_after_s:
            d["restartAfterS"] = self.restart_after_s
        if self.duration_s:
            d["durationS"] = self.duration_s
        if self.tenant:
            d["tenant"] = self.tenant
        return d


@dataclasses.dataclass
class TenantMix:
    """One tenant's slice of a multi-tenant storm: its OWN Zipf
    population/catalog and a rate scale relative to the scenario's
    ``baseRate`` — independent skews are the point (one tenant's head
    items must not warm another's cache)."""

    name: str
    population: int = 1_000
    items: int = 200
    rate_scale: float = 1.0
    item_alpha: float = 1.1

    _ALLOWED = {"name", "population", "items", "rateScale", "itemAlpha"}

    @classmethod
    def from_dict(cls, d: dict, path: str) -> "TenantMix":
        _expect(isinstance(d, dict), path, f"expected an object, got {d!r}")
        _reject_unknown(d, cls._ALLOWED, path)
        name = d.get("name")
        _expect(isinstance(name, str) and bool(name)
                and "/" not in name and " " not in name,
                f"{path}.name",
                f"expected a non-empty URL-safe string, got {name!r}")
        return cls(
            name=name,
            population=_int(d, "population", path, default=1_000, lo=1),
            items=_int(d, "items", path, default=200, lo=1),
            rate_scale=float(_num(d, "rateScale", path, default=1.0,
                                  lo=0.001)),
            item_alpha=float(_num(d, "itemAlpha", path, default=1.1,
                                  lo=0.0)))

    def to_dict(self) -> dict:
        return {"name": self.name, "population": self.population,
                "items": self.items, "rateScale": self.rate_scale,
                "itemAlpha": self.item_alpha}


@dataclasses.dataclass
class Scenario:
    """The validated storm description. Camel-case keys in the file
    (the repo's server.json convention), snake-case attributes here."""

    name: str = "storm"
    population: int = 10_000
    items: int = 2_000
    duration_s: float = 20.0
    seed: int = 7
    base_rate: float = 200.0          #: arrivals/s at the diurnal mean
    amplitude: float = 0.5
    period_s: float = 0.0             #: 0 = one full day-curve per run
    mix_events: float = 0.6
    mix_queries: float = 0.3
    mix_feedback: float = 0.1
    replicas: int = 2
    partitions: int = 2
    backend: str = "sqlite"
    max_outstanding: int = 256
    incidents: List[Incident] = dataclasses.field(default_factory=list)
    tenants: List[TenantMix] = dataclasses.field(default_factory=list)

    _ALLOWED = {"name", "population", "items", "durationS", "seed",
                "baseRate", "amplitude", "periodS", "mix", "replicas",
                "partitions", "backend", "maxOutstanding", "incidents",
                "tenants"}

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        _expect(isinstance(d, dict), "$", f"expected an object, got {d!r}")
        _reject_unknown(d, cls._ALLOWED, "$")
        name = d.get("name", "storm")
        _expect(isinstance(name, str) and name, "$.name",
                f"expected a non-empty string, got {name!r}")
        duration_s = float(_num(d, "durationS", "$", default=20.0, lo=0.5))
        mix = d.get("mix", {"events": 0.6, "queries": 0.3, "feedback": 0.1})
        _expect(isinstance(mix, dict), "$.mix",
                f"expected an object, got {mix!r}")
        _reject_unknown(mix, {"events", "queries", "feedback"}, "$.mix")
        me = _num(mix, "events", "$.mix", default=0.0, lo=0.0, hi=1.0)
        mq = _num(mix, "queries", "$.mix", default=0.0, lo=0.0, hi=1.0)
        mf = _num(mix, "feedback", "$.mix", default=0.0, lo=0.0, hi=1.0)
        _expect(abs(me + mq + mf - 1.0) < 1e-6, "$.mix",
                f"fractions must sum to 1.0, got {me + mq + mf:g}")
        backend = d.get("backend", "sqlite")
        _expect(backend in ("sqlite", "parquet"), "$.backend",
                f"expected 'sqlite' or 'parquet', got {backend!r}")
        incidents_raw = d.get("incidents", [])
        _expect(isinstance(incidents_raw, list), "$.incidents",
                f"expected an array, got {incidents_raw!r}")
        incidents = [
            Incident.from_dict(item, f"$.incidents[{i}]", duration_s)
            for i, item in enumerate(incidents_raw)]
        incidents.sort(key=lambda inc: inc.at_s)
        tenants_raw = d.get("tenants", [])
        _expect(isinstance(tenants_raw, list), "$.tenants",
                f"expected an array, got {tenants_raw!r}")
        tenants = [TenantMix.from_dict(item, f"$.tenants[{i}]")
                   for i, item in enumerate(tenants_raw)]
        tenant_names = {t.name for t in tenants}
        _expect(len(tenant_names) == len(tenants), "$.tenants",
                "tenant names must be unique")
        sc = cls(
            name=name,
            population=_int(d, "population", "$", default=10_000, lo=1),
            items=_int(d, "items", "$", default=2_000, lo=1),
            duration_s=duration_s,
            seed=_int(d, "seed", "$", default=7, lo=0),
            base_rate=float(_num(d, "baseRate", "$", default=200.0,
                                 lo=0.001)),
            amplitude=float(_num(d, "amplitude", "$", default=0.5,
                                 lo=0.0, hi=1.0)),
            period_s=float(_num(d, "periodS", "$", default=0.0, lo=0.0)),
            mix_events=float(me), mix_queries=float(mq),
            mix_feedback=float(mf),
            replicas=_int(d, "replicas", "$", default=2, lo=1, hi=16),
            partitions=_int(d, "partitions", "$", default=2, lo=1, hi=64),
            backend=backend,
            max_outstanding=_int(d, "maxOutstanding", "$", default=256,
                                 lo=1),
            incidents=incidents,
            tenants=tenants)
        for i, inc in enumerate(incidents):
            if inc.kind == "kill_replica":
                _expect(inc.target < sc.replicas,
                        f"$.incidents[{i}].target",
                        f"replica {inc.target} does not exist "
                        f"(fleet has {sc.replicas})")
            if inc.tenant:
                _expect(inc.tenant in tenant_names,
                        f"$.incidents[{i}].tenant",
                        f"tenant {inc.tenant!r} is not in $.tenants "
                        f"(have {sorted(tenant_names)})")
        return sc

    @classmethod
    def load(cls, path: str) -> "Scenario":
        try:
            with open(path) as f:
                data = json.load(f)
        except json.JSONDecodeError as e:
            raise ScenarioError(f"{path}: not valid JSON: {e}") from e
        return cls.from_dict(data)

    @property
    def effective_period_s(self) -> float:
        """The day-curve period actually used: an explicit ``periodS``,
        else one full cycle compressed into the run."""
        return self.period_s if self.period_s > 0 else self.duration_s

    def to_dict(self) -> dict:
        return {
            "name": self.name, "population": self.population,
            "items": self.items, "durationS": self.duration_s,
            "seed": self.seed, "baseRate": self.base_rate,
            "amplitude": self.amplitude, "periodS": self.period_s,
            "mix": {"events": self.mix_events, "queries": self.mix_queries,
                    "feedback": self.mix_feedback},
            "replicas": self.replicas, "partitions": self.partitions,
            "backend": self.backend,
            "maxOutstanding": self.max_outstanding,
            "incidents": [inc.to_dict() for inc in self.incidents],
            **({"tenants": [t.to_dict() for t in self.tenants]}
               if self.tenants else {}),
        }


def example_scenario() -> dict:
    """The scenario ``pio loadtest --example`` prints — a small chaos
    storm that kills replica 1 mid-run and restarts it."""
    return {
        "name": "example-chaos",
        "population": 50_000,
        "items": 5_000,
        "durationS": 30.0,
        "seed": 7,
        "baseRate": 300.0,
        "amplitude": 0.5,
        "mix": {"events": 0.6, "queries": 0.3, "feedback": 0.1},
        "replicas": 2,
        "partitions": 2,
        "backend": "sqlite",
        "maxOutstanding": 256,
        "incidents": [
            {"kind": "kill_replica", "atS": 8.0, "target": 1,
             "restartAfterS": 6.0},
            {"kind": "retrain", "atS": 12.0},
        ],
    }


def example_tenant_scenario() -> dict:
    """A multi-tenant storm for ``pio loadtest``: three tenants with
    independent Zipf skews behind ONE consolidated host, an incident
    burning tenant ``beta``'s SLO mid-run — the others' p99 must
    hold (admission sheds the burner, not its neighbours)."""
    return {
        "name": "example-multitenant",
        "durationS": 12.0,
        "seed": 7,
        "baseRate": 40.0,
        "amplitude": 0.3,
        "tenants": [
            {"name": "alpha", "population": 2_000, "items": 400,
             "rateScale": 1.0, "itemAlpha": 1.1},
            {"name": "beta", "population": 500, "items": 150,
             "rateScale": 0.5, "itemAlpha": 1.4},
            {"name": "gamma", "population": 5_000, "items": 800,
             "rateScale": 0.25, "itemAlpha": 0.9},
        ],
        "incidents": [
            {"kind": "burn_slo", "atS": 3.0, "tenant": "beta",
             "durationS": 4.0},
        ],
    }
