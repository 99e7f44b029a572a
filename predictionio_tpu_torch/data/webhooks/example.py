"""The example connectors, ``examplejson`` and ``exampleform`` (the
reference's ExampleJsonConnector.scala:25-95 and
ExampleFormConnector.scala:58-104): ``userAction`` and
``userActionItem`` payloads become user events, their context and
extra properties folded into ``properties``.
"""

from __future__ import annotations

import json

from predictionio_tpu_torch.data.webhooks import (
    ConnectorError, WebhookConnector,
)


def _event(data, getter, props_keys, with_item: bool) -> dict:
    props = {}
    context = getter(data, "context")
    if context is not None:
        props["context"] = context
    for k in props_keys:
        v = getter(data, k)
        if v is not None:
            props[k] = v
    out = {"event": data["event"], "entityType": "user",
           "entityId": data["userId"]}
    if with_item:
        out["targetEntityType"] = "item"
        out["targetEntityId"] = data["itemId"]
    out["properties"] = props
    if data.get("timestamp"):
        out["eventTime"] = data["timestamp"]
    return out


def _convert(payload: dict, getter) -> dict:
    ptype = payload.get("type")
    try:
        if ptype == "userAction":
            return _event(payload, getter,
                          ("anotherProperty1", "anotherProperty2"), False)
        if ptype == "userActionItem":
            return _event(payload, getter,
                          ("anotherPropertyA", "anotherPropertyB"), True)
    except KeyError as e:
        raise ConnectorError(
            f"Cannot convert {payload} to event JSON: missing {e}") from e
    raise ConnectorError(
        f"Cannot convert unknown type '{ptype}' to Event JSON.")


class ExampleJsonConnector(WebhookConnector):
    name = "examplejson"
    form_based = False

    def to_event_dict(self, payload: dict) -> dict:
        return _convert(payload, lambda d, k: d.get(k))


def _form_value(data: dict, key: str):
    """A form field, parsed as JSON where it is JSON (the context
    arrives as a JSON string)."""
    v = data.get(key)
    if v is None:
        return None
    try:
        return json.loads(v)
    except (json.JSONDecodeError, TypeError):
        return v


class ExampleFormConnector(WebhookConnector):
    name = "exampleform"
    form_based = True

    def to_event_dict(self, payload: dict) -> dict:
        return _convert(payload, _form_value)
