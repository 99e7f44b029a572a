"""The MailChimp connector, form-encoded (the reference's
MailChimpConnector.scala:32-360): ``subscribe``, ``unsubscribe``,
``profile``, ``upemail``, ``cleaned`` and ``campaign`` payloads become
events; ``fired_at`` (``yyyy-MM-dd HH:mm:ss``, UTC) the event time;
the ``data[...]`` bracket fields nested into ``properties``.
"""

from __future__ import annotations

import datetime as _dt
import re

from predictionio_tpu_torch.data.event import UTC, format_event_time
from predictionio_tpu_torch.data.webhooks import (
    ConnectorError, WebhookConnector,
)

_BRACKETS = re.compile(r"\[([^\]]*)\]")


def parse_mailchimp_time(s: str) -> str:
    try:
        t = _dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(
            tzinfo=UTC)
    except ValueError as e:
        raise ConnectorError(f"cannot parse fired_at {s!r}: {e}") from e
    return format_event_time(t)


def _unflatten(data: dict) -> dict:
    """``data[merges][FNAME]=x`` -> ``{"merges": {"FNAME": "x"}}``."""
    out: dict = {}
    for key, value in data.items():
        if not key.startswith("data["):
            continue
        path = _BRACKETS.findall(key)
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


def _require(data: dict, key: str) -> str:
    if key not in data:
        raise ConnectorError(
            f"The field '{key}' is required for MailChimp data.")
    return data[key]


class MailChimpConnector(WebhookConnector):
    name = "mailchimp"
    form_based = True

    #: type -> (event name, entity id field, a list as target entity)
    _SHAPES = {
        "subscribe": ("subscribe", "data[id]", True),
        "unsubscribe": ("unsubscribe", "data[id]", True),
        "profile": ("profile", "data[id]", True),
        "upemail": ("upemail", "data[new_id]", True),
        "cleaned": ("cleaned", "data[list_id]", False),
        "campaign": ("campaign", "data[id]", True),
    }

    def to_event_dict(self, payload: dict) -> dict:
        ptype = payload.get("type")
        if ptype is None:
            raise ConnectorError(
                "The field 'type' is required for MailChimp data.")
        if ptype not in self._SHAPES:
            raise ConnectorError(f"Cannot convert unknown MailChimp data "
                                 f"type {ptype} to event JSON")
        event_name, id_field, has_list_target = self._SHAPES[ptype]
        event_time = parse_mailchimp_time(_require(payload, "fired_at"))
        props = _unflatten(payload)
        entity_id = _require(payload, id_field)
        # the identity fields live on the event, not in its properties
        for consumed in (("id", "new_id") if ptype == "upemail"
                         else ("id",)):
            props.pop(consumed, None)
        out = {
            "event": event_name,
            "entityType": "list" if ptype == "cleaned" else
                          ("campaign" if ptype == "campaign" else "user"),
            "entityId": entity_id,
            "properties": props,
            "eventTime": event_time,
        }
        if (has_list_target and ptype != "campaign"
                and "data[list_id]" in payload):
            out["targetEntityType"] = "list"
            out["targetEntityId"] = payload["data[list_id]"]
            props.pop("list_id", None)
        return out
