"""The universal event datum, its JSON wire format (the Event Server's
REST API) and its validation rules (copy of the reference's
``data/event.py``).

Behavioral parity with the reference's Event model
(data/.../storage/Event.scala:42-167): an event is
(event_id?, event, entity_type, entity_id, target_entity_type?,
target_entity_id?, properties, event_time, tags, pr_id?, creation_time),
with reserved `$set/$unset/$delete` special events and `pio_` name prefixes.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
from typing import Any, Mapping, Optional, Sequence

from predictionio_tpu_torch.data.datamap import DataMap

UTC = _dt.timezone.utc

#: Reserved single-entity event names (Event.scala:83)
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Built-in entity types allowed to use the reserved prefix (Event.scala:144)
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})

#: Built-in property names allowed to use the reserved prefix (currently empty)
BUILTIN_PROPERTIES: frozenset = frozenset()


class EventValidationError(ValueError):
    """An event violates the validation rules (Event.scala:112-141)."""


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def is_reserved_prefix(name: str) -> bool:
    """True if the name starts with `$` or `pio_` (Event.scala:77)."""
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


@dataclasses.dataclass(frozen=True)
class Event:
    """One event in the Event Store (Event.scala:42-60)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    event_id: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        for attr in ("event_time", "creation_time"):
            t = getattr(self, attr)
            if t.tzinfo is None:  # naive timestamps are taken as UTC
                object.__setattr__(self, attr, t.replace(tzinfo=UTC))
        object.__setattr__(self, "tags", tuple(self.tags))

    # -- JSON round-trip (wire format of the Event Server REST API) ---------
    def to_dict(self) -> dict:
        d: dict = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.fields,
            "eventTime": format_event_time(self.event_time),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        d["creationTime"] = format_event_time(self.creation_time)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Event":
        if not isinstance(d, Mapping):
            raise EventValidationError("event must be a JSON object")
        for key in ("event", "entityType", "entityId"):
            if key not in d:
                raise EventValidationError(f"field {key} is required")
        props = d.get("properties") or {}
        if not isinstance(props, Mapping):
            raise EventValidationError("properties must be a JSON object")
        return cls(
            event=_req_str(d, "event"),
            entity_type=_req_str(d, "entityType"),
            entity_id=_req_str(d, "entityId"),
            target_entity_type=_opt_str(d, "targetEntityType"),
            target_entity_id=_opt_str(d, "targetEntityId"),
            properties=DataMap(props),
            event_time=(parse_event_time(d["eventTime"])
                        if d.get("eventTime") is not None else _utcnow()),
            tags=tuple(d.get("tags") or ()),
            pr_id=_opt_str(d, "prId"),
            creation_time=(parse_event_time(d["creationTime"])
                           if d.get("creationTime") is not None
                           else _utcnow()),
            event_id=_opt_str(d, "eventId"),
        )

    @classmethod
    def from_json(cls, s: str) -> "Event":
        return cls.from_dict(json.loads(s))


def _req_str(d: Mapping[str, Any], key: str) -> str:
    v = d[key]
    if not isinstance(v, str):
        raise EventValidationError(f"field {key} must be a string")
    return v


def _opt_str(d: Mapping[str, Any], key: str) -> Optional[str]:
    v = d.get(key)
    if v is None:
        return None
    if not isinstance(v, str):
        raise EventValidationError(f"field {key} must be a string")
    return v


def parse_event_time(s: str) -> _dt.datetime:
    """Parse ISO-8601 with timezone; naive times are UTC (Event.scala:73)."""
    if not isinstance(s, str):
        raise EventValidationError(
            f"eventTime must be an ISO-8601 string, got {s!r}")
    try:
        t = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError as e:
        raise EventValidationError(f"cannot parse time {s!r}: {e}") from e
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t


def format_event_time(t: _dt.datetime) -> str:
    """ISO-8601 to the millisecond, UTC when naive: the reference's
    string, so ``GET /events.json`` answers agree byte for byte."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t.isoformat(timespec="milliseconds")


def millis(t: _dt.datetime) -> int:
    """Epoch milliseconds — the aggregation/order key (joda getMillis parity)."""
    return int(t.timestamp() * 1000)


def validate_event(e: Event) -> None:
    """Validate an event, raising EventValidationError on any violation.

    Rule-for-rule parity with EventValidation.validate (Event.scala:112-141).
    """
    if not e.event:
        raise EventValidationError("event must not be empty.")
    if not e.entity_type:
        raise EventValidationError("entityType must not be empty string.")
    if not e.entity_id:
        raise EventValidationError("entityId must not be empty string.")
    if e.target_entity_type == "":
        raise EventValidationError("targetEntityType must not be empty string")
    if e.target_entity_id == "":
        raise EventValidationError("targetEntityId must not be empty string.")
    if (e.target_entity_type is None) != (e.target_entity_id is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be specified together.")
    if e.event == "$unset" and e.properties.is_empty:
        raise EventValidationError("properties cannot be empty for $unset event")
    if is_reserved_prefix(e.event) and not is_special_event(e.event):
        raise EventValidationError(
            f"{e.event} is not a supported reserved event name.")
    if is_special_event(e.event) and e.target_entity_type is not None:
        raise EventValidationError(
            f"Reserved event {e.event} cannot have targetEntity")
    if is_reserved_prefix(e.entity_type) and e.entity_type not in BUILTIN_ENTITY_TYPES:
        raise EventValidationError(
            f"The entityType {e.entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.")
    if (e.target_entity_type is not None
            and is_reserved_prefix(e.target_entity_type)
            and e.target_entity_type not in BUILTIN_ENTITY_TYPES):
        raise EventValidationError(
            f"The targetEntityType {e.target_entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.")
    for k in e.properties.key_set():
        if is_reserved_prefix(k) and k not in BUILTIN_PROPERTIES:
            raise EventValidationError(
                f"The property {k} is not allowed. "
                "'pio_' is a reserved name prefix.")
