"""The universal event datum and its validation rules (copy of the
reference's ``data/event.py`` without the event server's JSON wire
format, which comes with the event server).

Behavioral parity with the reference's Event model
(data/.../storage/Event.scala:42-167): an event is
(event_id?, event, entity_type, entity_id, target_entity_type?,
target_entity_id?, properties, event_time, tags, pr_id?, creation_time),
with reserved `$set/$unset/$delete` special events and `pio_` name prefixes.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Optional, Sequence

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
