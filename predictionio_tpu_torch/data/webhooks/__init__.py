"""Webhook connectors: third-party payloads -> Events (port of the
reference's ``data/webhooks``; the registry of WebhooksConnectors.scala
:27-37). A connector turns one provider's payload (a JSON body or form
fields) into an Event dict; the event server validates and stores it.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

from predictionio_tpu_torch.data.event import Event


class ConnectorError(Exception):
    """The payload cannot be converted (ConnectorException)."""


class WebhookConnector(abc.ABC):
    """A connector; ``form_based`` reads the body as form fields, else
    as JSON."""

    name: str = ""
    form_based: bool = False

    @abc.abstractmethod
    def to_event_dict(self, payload: dict) -> dict:
        """The payload as an Event wire dict (may raise
        :class:`ConnectorError`)."""

    def to_event(self, payload: dict) -> Event:
        return Event.from_dict(self.to_event_dict(payload))


_REGISTRY: Dict[str, WebhookConnector] = {}


def register_connector(connector: WebhookConnector) -> None:
    _REGISTRY[connector.name] = connector


def get_connector(name: str) -> Optional[WebhookConnector]:
    _ensure_builtin()
    return _REGISTRY.get(name)


_loaded = False


def _ensure_builtin() -> None:
    """The built-in connectors, registered on first use."""
    global _loaded
    if _loaded:
        return
    from predictionio_tpu_torch.data.webhooks import (
        example, mailchimp, segmentio,
    )

    register_connector(segmentio.SegmentIOConnector())
    register_connector(mailchimp.MailChimpConnector())
    register_connector(example.ExampleJsonConnector())
    register_connector(example.ExampleFormConnector())
    _loaded = True
