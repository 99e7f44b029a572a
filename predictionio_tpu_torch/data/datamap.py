"""Schemaless JSON property bags (copy of the reference's
``data/datamap.py``).

Behavioral parity with the reference's `DataMap` / `PropertyMap`
(data/.../storage/DataMap.scala:45-245, PropertyMap.scala:36-99): a DataMap is
an immutable mapping from field name to a JSON value with typed getters; a
PropertyMap additionally carries first/last updated times and is the result of
folding `$set/$unset/$delete` events (see aggregator.py).
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Any, Iterator, Mapping, Optional, Type, TypeVar

T = TypeVar("T")

_JSON_TYPES = (type(None), bool, int, float, str, list, dict)


class DataMapError(Exception):
    """Raised when a required field is missing or has the wrong type.

    (Parity with the reference's DataMapException.)
    """


def _copy_json_value(name: str, value: Any) -> Any:
    """Validate recursively and return a deep copy of container values.

    The copy keeps DataMap immutable even when the caller retains references
    to nested lists/dicts; the recursive check rejects non-JSON leaves at
    construction instead of at serialization time.
    """
    if isinstance(value, (type(None), bool, int, float, str)):
        return value
    if isinstance(value, list):
        return [_copy_json_value(name, v) for v in value]
    if isinstance(value, dict):
        for k in value:
            if not isinstance(k, str):
                raise DataMapError(f"field {name!r} has non-string object key {k!r}")
        return {k: _copy_json_value(name, v) for k, v in value.items()}
    raise DataMapError(
        f"field {name!r} has non-JSON value of type {type(value).__name__}")


class DataMap(Mapping[str, Any]):
    """Immutable mapping of field name -> JSON value with typed getters."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        f = {k: _copy_json_value(k, v) for k, v in dict(fields).items()} if fields else {}
        object.__setattr__(self, "_fields", f)

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return dict(self._fields) == dict(other)
        return NotImplemented

    def __hash__(self) -> int:  # stable enough for test use
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- reference API ------------------------------------------------------
    @property
    def fields(self) -> dict:
        return dict(self._fields)

    @property
    def is_empty(self) -> bool:
        return not self._fields

    def key_set(self) -> set:
        return set(self._fields)

    def require(self, name: str) -> None:
        """Parity with DataMap.require (DataMap.scala:60)."""
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def get(self, name: str, cls: Optional[Type[T]] = None) -> Any:
        """Mandatory typed getter: raises if absent or null.

        Parity with DataMap.get[T] (DataMap.scala:78): a present-but-null
        field raises, because a mandatory field cannot be None.

        NOTE: this deliberately shadows Mapping.get(key, default) — DataMap's
        `get` is the reference's mandatory typed getter. Use get_opt /
        get_or_else for optional access with defaults.
        """
        if cls is not None and not isinstance(cls, type):
            raise DataMapError(
                f"DataMap.get(name, cls) takes a type, got {cls!r}; "
                "use get_or_else(name, default) for defaults.")
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        return _coerce(name, value, cls)

    def get_opt(self, name: str, cls: Optional[Type[T]] = None) -> Optional[Any]:
        """Optional typed getter: None when absent or null (DataMap.scala:94)."""
        value = self._fields.get(name)
        if value is None:
            return None
        return _coerce(name, value, cls)

    def get_or_else(self, name: str, default: T, cls: Optional[Type[T]] = None) -> T:
        out = self.get_opt(name, cls)
        return default if out is None else out

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        parsed = json.loads(s)
        if not isinstance(parsed, dict):
            raise DataMapError("DataMap JSON must be an object")
        return cls(parsed)


def _coerce(name: str, value: Any, cls: Optional[type]) -> Any:
    if cls is None:
        return value
    if cls is float and isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    if cls is int and isinstance(value, int) and not isinstance(value, bool):
        return value
    if not isinstance(value, cls) or (cls is not bool and isinstance(value, bool) and cls in (int, float)):
        raise DataMapError(
            f"field {name!r} is {type(value).__name__}, expected {cls.__name__}")
    return value


class PropertyMap(DataMap):
    """DataMap plus first/last updated times.

    The result of folding `$set/$unset/$delete` events for one entity
    (PropertyMap.scala:36-99).
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(self, fields: Optional[Mapping[str, Any]],
                 first_updated: _dt.datetime, last_updated: _dt.datetime):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:
        return (f"PropertyMap({self.fields!r}, firstUpdated={self.first_updated}, "
                f"lastUpdated={self.last_updated})")

    def __eq__(self, other: object) -> bool:
        # Strict: a PropertyMap only equals another PropertyMap (fields AND
        # times). Comparing against a plain DataMap/dict is always False to
        # keep equality transitive; compare `.fields` explicitly instead.
        if isinstance(other, PropertyMap):
            return (self.fields == other.fields
                    and self.first_updated == other.first_updated
                    and self.last_updated == other.last_updated)
        if isinstance(other, Mapping):
            return False
        return NotImplemented

    __hash__ = DataMap.__hash__
