"""The segment.io connector (the reference's
SegmentIOConnector.scala:24-185): ``identify``, ``track``, ``alias``,
``page``, ``screen`` and ``group`` payloads become a user event named
after the type, entity id the user id else the anonymous id, event time
the timestamp, the type's fields (and the context) in ``properties``.
"""

from __future__ import annotations

from predictionio_tpu_torch.data.webhooks import (
    ConnectorError, WebhookConnector,
)

_TYPE_PROPS = {
    "identify": lambda d: {"traits": d.get("traits")},
    "track": lambda d: {"properties": d.get("properties"),
                        "event": d.get("event")},
    "alias": lambda d: {"previous_id": d.get("previousId")
                        or d.get("previous_id")},
    "screen": lambda d: {"name": d.get("name"),
                         "properties": d.get("properties")},
    "page": lambda d: {"name": d.get("name"),
                       "properties": d.get("properties")},
    "group": lambda d: {"group_id": d.get("groupId") or d.get("group_id"),
                        "traits": d.get("traits")},
}


class SegmentIOConnector(WebhookConnector):
    name = "segmentio"
    form_based = False

    def to_event_dict(self, payload: dict) -> dict:
        if "version" not in payload:
            raise ConnectorError("Failed to get segment.io API version.")
        ptype = payload.get("type")
        if ptype not in _TYPE_PROPS:
            raise ConnectorError(
                f"Cannot convert unknown type {ptype} to event JSON.")
        user_id = (payload.get("userId") or payload.get("user_id")
                   or payload.get("anonymousId")
                   or payload.get("anonymous_id"))
        if not user_id:
            raise ConnectorError("there was no `userId` or `anonymousId` "
                                 "in the common fields.")
        props = {k: v for k, v in _TYPE_PROPS[ptype](payload).items()
                 if v is not None}
        context = payload.get("context")
        if context is not None:
            props["context"] = context
        out = {"event": ptype, "entityType": "user",
               "entityId": str(user_id), "properties": props}
        if payload.get("timestamp"):
            out["eventTime"] = payload["timestamp"]
        return out
