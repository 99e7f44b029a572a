"""Event Server — REST event ingest, port 7070 (port of the reference's
``server/event_server.py``, EventServer.scala):

  GET    /                    -> {"status": "alive"}          (:150)
  POST   /events.json         -> 201 {"eventId": id}          (:241)
  GET    /events.json         -> events matching the filters  (:274)
  GET    /events/<id>.json    -> one event                    (:207)
  DELETE /events/<id>.json    -> {"message": "Found"}         (:224)
  POST   /batch/events.json   -> per-event statuses in the
                                 original order, at most
                                 ``maxEventsPerBatch``         (:340)
  GET    /plugins.json        -> the registered input blockers
                                 and sniffers                  (:155)
  *      /plugins/<type>/<name>/<args...> -> that plugin's
                                 ``handle_rest`` (the reference's
                                 ``event_server.py:398-412``)

Auth (:92-142): the ``accessKey`` query parameter, else an
``Authorization: Basic <key:>`` header; a key restricted to some event
names answers 403 for others; ``channel`` resolves through the app's
channels. Writes go through the group-commit ``WriteBuffer``
(``data/write_buffer``): a full queue answers 429 with Retry-After, a
storage failure after the retries 503, and a shutdown drains the buffer.
``PIO_INGEST_BUFFER=0`` writes per request instead (a storage failure
then answers 500, as in the reference).

Input blockers (``server/plugins``) run on every event of both ingest
routes before the insert; one that raises rejects the event with 403
and its message. Input sniffers see each stored event after the
insert.

The HTTP layer is the port's stdlib one (``server/http``); the
reference's ``/stats.json``, webhooks, ``/metrics`` and history routes
are not ported yet.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import logging
from typing import Any, List, Optional, Tuple

from predictionio_tpu_torch.data.event import (
    Event, EventValidationError, parse_event_time, validate_event,
)
from predictionio_tpu_torch.data.write_buffer import BufferFull, WriteBuffer
from predictionio_tpu_torch.server.http import (
    HttpError, HttpServer, Request, serve_until_stopped,
)
from predictionio_tpu_torch.server.plugins import (
    EVENTSERVER_GROUP, PluginContext,
)
from predictionio_tpu_torch.storage.base import StorageError
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    IngestConfig, ingest_config,
)

logger = logging.getLogger("pio.torch.eventserver")

DEFAULT_PORT = 7070


class AuthData:
    __slots__ = ("app_id", "channel_id", "events")

    def __init__(self, app_id: int, channel_id: Optional[int], events):
        self.app_id = app_id
        self.channel_id = channel_id
        self.events = tuple(events)


class EventServer:
    """``start`` binds on the running event loop; ``close`` stops
    accepting and drains the write buffer; :func:`run_event_server` is
    the blocking form."""

    def __init__(self, ingest: Optional[IngestConfig] = None,
                 plugin_context: Optional[PluginContext] = None):
        self.ingest_config = ingest or ingest_config()
        self.plugins = plugin_context or PluginContext(EVENTSERVER_GROUP)
        ic = self.ingest_config
        self.buffer: Optional[WriteBuffer] = None
        if ic.buffer:
            self.buffer = WriteBuffer(
                Storage.get_events, queue_max=ic.queue_max,
                flush_max=ic.flush_max, linger_s=ic.linger_s,
                retries=ic.retries, backoff_s=ic.backoff_s,
                backoff_cap_s=ic.backoff_cap_s,
                flush_timeout_s=ic.flush_timeout_s)
        self._http = HttpServer([
            ("GET", "/", self.handle_root),
            ("POST", "/events.json", self.handle_create),
            ("GET", "/events.json", self.handle_find),
            ("GET", "/events/{event_id}.json", self.handle_get),
            ("DELETE", "/events/{event_id}.json", self.handle_delete),
            ("POST", "/batch/events.json", self.handle_batch),
            ("GET", "/plugins.json", self.handle_plugins),
            ("*", "/plugins/{tail:.*}", self.handle_plugin_rest),
        ])
        #: set to shut :func:`run_event_server` down
        self.stopped = asyncio.Event()

    async def start(self, host: str = "localhost",
                    port: int = DEFAULT_PORT) -> int:
        return await self._http.start(host, port)

    async def close(self) -> None:
        """Stop accepting, then flush every buffered event: accepted
        events are never dropped by a graceful shutdown."""
        await self._http.close()
        if self.buffer is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self.buffer.stop)

    # -- auth ---------------------------------------------------------------
    @staticmethod
    async def _run(fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    async def _auth(self, req: Request) -> AuthData:
        """The query parameter first, then the Basic header."""
        access_key = req.query.get("accessKey")
        if access_key is None:
            header = req.headers.get("authorization", "")
            if not header.startswith("Basic "):
                raise HttpError(401, "Missing accessKey.")
            try:
                decoded = base64.b64decode(header[len("Basic "):]).decode()
            except (binascii.Error, UnicodeDecodeError):
                raise HttpError(401, "Invalid accessKey.") from None
            access_key = decoded.strip().split(":")[0]
        key = await self._run(Storage.get_meta_data_access_keys().get,
                              access_key)
        if key is None:
            raise HttpError(401, "Invalid accessKey.")
        channel_id = None
        channel = req.query.get("channel")
        if channel is not None:
            channels = await self._run(
                Storage.get_meta_data_channels().get_by_appid, key.appid)
            matched = [c for c in channels if c.name == channel]
            if not matched:
                raise HttpError(401, f"Invalid channel '{channel}'.")
            channel_id = matched[0].id
        return AuthData(key.appid, channel_id, key.events)

    # -- writes -------------------------------------------------------------
    async def _insert(self, events: List[Event], auth: AuthData
                      ) -> List[str]:
        """Persist events, returning their ids: through the buffer
        (BufferFull / StorageError propagate), or one insert_batch on a
        worker thread when the buffer is off."""
        if self.buffer is not None:
            return await asyncio.wrap_future(
                self.buffer.submit(events, auth.app_id, auth.channel_id))
        return await self._run(Storage.get_events().insert_batch, events,
                               auth.app_id, auth.channel_id)

    @staticmethod
    def _shed(bf: BufferFull) -> Tuple[int, Any, dict]:
        return 429, {"message": str(bf)}, {"Retry-After":
                                           str(bf.retry_after)}

    def _storage_status(self) -> int:
        # a buffered failure already spent its retries: retryable 503;
        # the direct path keeps the reference's 500
        return 503 if self.buffer is not None else 500

    # -- routes -------------------------------------------------------------
    async def handle_root(self, _req: Request):
        return 200, {"status": "alive"}

    async def handle_create(self, req: Request):
        auth = await self._auth(req)
        try:
            event = Event.from_dict(req.json())
            validate_event(event)
        except (EventValidationError, json.JSONDecodeError, TypeError,
                AttributeError, ValueError) as e:
            return 400, {"message": str(e)}
        if auth.events and event.event not in auth.events:
            return 403, {"message": f"{event.event} events are not allowed"}
        blocked = self._blocked(auth, event)
        if blocked is not None:
            return 403, {"message": blocked}
        try:
            event_id = (await self._insert([event], auth))[0]
        except BufferFull as bf:
            return self._shed(bf)
        except StorageError as e:
            return self._storage_status(), {"message": str(e)}
        self._sniff(auth, event)
        return 201, {"eventId": event_id}

    async def handle_find(self, req: Request):
        auth = await self._auth(req)
        q = req.query
        try:
            reversed_order = q.get("reversed", "false").lower() == "true"
            if reversed_order and not (q.get("entityType")
                                       and q.get("entityId")):
                # EventServer.scala:302-305
                return 400, {"message": "the parameter reversed can only "
                                        "be used with both entityType and "
                                        "entityId specified."}
            kwargs = dict(
                start_time=(parse_event_time(q["startTime"])
                            if "startTime" in q else None),
                until_time=(parse_event_time(q["untilTime"])
                            if "untilTime" in q else None),
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=[q["event"]] if "event" in q else None,
                limit=int(q.get("limit", 20)),  # default 20 (:319)
                reversed_order=reversed_order,
            )
            if "targetEntityType" in q:
                kwargs["target_entity_type"] = q["targetEntityType"]
            if "targetEntityId" in q:
                kwargs["target_entity_id"] = q["targetEntityId"]
        except (EventValidationError, ValueError) as e:
            return 400, {"message": str(e)}

        def find():
            return list(Storage.get_events().find(
                auth.app_id, auth.channel_id, **kwargs))

        try:
            events = await self._run(find)
        except StorageError as e:
            return 500, {"message": str(e)}
        if not events:
            return 404, {"message": "Not Found"}
        return 200, [e.to_dict() for e in events]

    async def handle_get(self, req: Request):
        auth = await self._auth(req)
        try:
            event = await self._run(Storage.get_events().get,
                                    req.params["event_id"], auth.app_id,
                                    auth.channel_id)
        except StorageError as e:
            return 500, {"message": str(e)}
        if event is None:
            return 404, {"message": "Not Found"}
        return 200, event.to_dict()

    async def handle_delete(self, req: Request):
        auth = await self._auth(req)
        try:
            found = await self._run(Storage.get_events().delete,
                                    req.params["event_id"], auth.app_id,
                                    auth.channel_id)
        except StorageError as e:
            return 500, {"message": str(e)}
        if found:
            return 200, {"message": "Found"}
        return 404, {"message": "Not Found"}

    async def handle_batch(self, req: Request):
        """EventServer.scala:340-419 — per-event results, original
        order; a storage failure answers a retryable 503 for each event
        it took (buffered or not, as in the reference), the 400/403
        entries stand."""
        auth = await self._auth(req)
        try:
            body = req.json()
            if not isinstance(body, list):
                raise ValueError("batch body must be a JSON array")
        except ValueError as e:          # JSONDecodeError included
            return 400, {"message": str(e)}
        max_batch = self.ingest_config.max_events_per_batch
        if len(body) > max_batch:
            return 400, {"message": "Batch request must have less than or "
                                    f"equal to {max_batch} events"}
        results: List[Optional[dict]] = [None] * len(body)
        to_insert = []  # (index, event)
        for i, item in enumerate(body):
            try:
                event = Event.from_dict(item)
                validate_event(event)
            except (EventValidationError, TypeError, AttributeError) as e:
                results[i] = {"status": 400, "message": str(e)}
                continue
            if auth.events and event.event not in auth.events:
                results[i] = {"status": 403, "message":
                              f"{event.event} events are not allowed"}
                continue
            blocked = self._blocked(auth, event)
            if blocked is not None:
                results[i] = {"status": 403, "message": blocked}
                continue
            to_insert.append((i, event))
        if to_insert:
            try:
                ids = await self._insert([e for _, e in to_insert], auth)
            except BufferFull as bf:
                # nothing was accepted: shed the whole request
                return self._shed(bf)
            except StorageError as e:
                for i, _event in to_insert:
                    results[i] = {"status": 503, "message": str(e)}
            else:
                for (i, event), event_id in zip(to_insert, ids):
                    self._sniff(auth, event)
                    results[i] = {"status": 201, "eventId": event_id}
        return 200, results

    # -- plugins (EventServer.scala:155-189) --------------------------------
    def _blocked(self, auth: AuthData, event: Event) -> Optional[str]:
        """The message of the first input blocker that rejects
        ``event``, else None."""
        for blocker in self.plugins.input_blockers.values():
            try:
                blocker.process(auth.app_id, auth.channel_id, event)
            except Exception as e:      # the blocker rejected the event
                return str(e)
        return None

    def _sniff(self, auth: AuthData, event: Event) -> None:
        for sniffer in self.plugins.input_sniffers.values():
            try:
                sniffer.process(auth.app_id, auth.channel_id, event)
            except Exception:
                logger.exception("input sniffer failed")

    async def handle_plugins(self, _req: Request):
        return 200, {"plugins": self.plugins.describe()}

    async def handle_plugin_rest(self, req: Request):
        auth = await self._auth(req)
        segments = req.params["tail"].split("/")
        if len(segments) < 2:
            return 404, {"message": "Not Found"}
        plugin_type, plugin_name, *args = segments
        registry = {"inputblockers": self.plugins.input_blockers,
                    "inputsniffers": self.plugins.input_sniffers
                    }.get(plugin_type)
        if registry is None or plugin_name not in registry:
            return 404, {"message": "Not Found"}
        return 200, registry[plugin_name].handle_rest(
            auth.app_id, auth.channel_id, args)


def run_event_server(host: str = "localhost", port: int = DEFAULT_PORT,
                     on_ready=None) -> None:
    """Serve until SIGINT or SIGTERM, then drain the write buffer.
    ``on_ready(port)`` runs once the socket is bound."""
    serve_until_stopped(EventServer(), host, port, on_ready)
