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
  GET    /stats.json          -> ingest counters (``--stats``)  (:421)
  GET    /plugins.json        -> the registered input blockers
                                 and sniffers                  (:155)
  *      /plugins/<type>/<name>/<args...> -> that plugin's
                                 ``handle_rest`` (the reference's
                                 ``event_server.py:398-412``)
  POST   /webhooks/<name>.json -> 201 {"eventId": id}: the payload
                                 through that connector
                                 (``data/webhooks``)           (:442)
  GET    /webhooks/<name>.json -> the connector's liveness

Auth (:92-142): the ``accessKey`` query parameter, else an
``Authorization: Basic <key:>`` header; a key restricted to some event
names answers 403 for others; ``channel`` resolves through the app's
channels. Writes go through the group-commit ``WriteBuffer``
(``data/write_buffer``), one commit lane per partition of the event
store (``PIO_INGEST_PARTITIONS``): a full lane answers 429 with
Retry-After, a
storage failure after the retries 503, and a shutdown drains the buffer.
``PIO_INGEST_BUFFER=0`` writes per request instead (a storage failure
then answers 500, as in the reference).

Input blockers (``server/plugins``) run on every event of both ingest
routes before the insert; one that raises rejects the event with 403
and its message. Input sniffers see each stored event after the
insert.

Every event's outcome is counted as the reference counts it:
``pio_event_ingest_total{status}``, ``pio_event_rejected_total{reason}``
(``invalid``, ``forbidden``, ``blocked``, ``shed``, ``storage_error``)
and, once per ``/batch/events.json`` request, ``pio_event_batch_size``.
Every request runs under the observability middleware
(``obs/middleware``); ``/metrics``, ``/metrics.json``,
``/debug/traces.json``, ``/capacity.json`` and ``/history/*.json`` are
served unauthenticated, as in the reference. The write buffer observes
each submit's ``flush_wait`` and ``commit`` anatomy stages.

A webhook's payload is a JSON body, or form fields for the form-based
connectors (``mailchimp``, ``exampleform``; read as aiohttp's
``request.post()`` reads them); its event takes the key auth and the
write path of the other ingest routes. An unknown connector answers 404.

The HTTP layer is the port's stdlib one (``server/http``);
:func:`run_event_server` listens over TLS when server.json's ``ssl``
section (or ``PIO_SSL_CERTFILE``) turns it on.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import logging
from typing import Any, List, Optional, Tuple

from predictionio_tpu_torch.data import webhooks
from predictionio_tpu_torch.data.event import (
    Event, EventValidationError, parse_event_time, validate_event,
)
from predictionio_tpu_torch.data.write_buffer import BufferFull, WriteBuffer
from predictionio_tpu_torch.obs.capacity import (
    capacity_routes, register_capacity_metrics,
)
from predictionio_tpu_torch.obs.middleware import (
    metrics_routes, observability_middleware,
)
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.telemetry import (
    build_recorder, history_reader_factory, history_routes,
)
from predictionio_tpu_torch.server.http import (
    HttpError, HttpServer, Request, serve_until_stopped,
)
from predictionio_tpu_torch.server.plugins import (
    EVENTSERVER_GROUP, PluginContext,
)
from predictionio_tpu_torch.server.stats import Stats
from predictionio_tpu_torch.storage.base import StorageError
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    IngestConfig, ServerConfig, ingest_config,
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
                 plugin_context: Optional[PluginContext] = None,
                 stats: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 telemetry=None):
        self.ingest_config = ingest or ingest_config()
        #: ``--stats``: per-app ingest bookkeeping at ``/stats.json``
        self.stats_enabled = stats
        self.registry = registry or MetricsRegistry()
        self.stats = Stats(registry=self.registry)
        register_capacity_metrics(self.registry)
        self._ingest_total = self.registry.counter(
            "pio_event_ingest_total",
            "Event ingest attempts by response status",
            labelnames=("status",))
        self._rejected_total = self.registry.counter(
            "pio_event_rejected_total",
            "Rejected events by reason (invalid/forbidden/blocked/storage)",
            labelnames=("reason",))
        self._batch_size = self.registry.histogram(
            "pio_event_batch_size", "Events per /batch/events.json request",
            buckets=(1, 2, 5, 10, 20, 50))
        #: the durable-telemetry recorder (``obs/telemetry``), owned by
        #: this server when given: stopped last on close
        self.telemetry = telemetry
        self.plugins = plugin_context or PluginContext(EVENTSERVER_GROUP)
        ic = self.ingest_config
        self.buffer: Optional[WriteBuffer] = None
        if ic.buffer:
            self.buffer = WriteBuffer(
                Storage.get_events, queue_max=ic.queue_max,
                flush_max=ic.flush_max, linger_s=ic.linger_s,
                retries=ic.retries, backoff_s=ic.backoff_s,
                backoff_cap_s=ic.backoff_cap_s,
                flush_timeout_s=ic.flush_timeout_s,
                partitions=ic.partitions, registry=self.registry)
        self._http = HttpServer([
            ("GET", "/", self.handle_root),
            ("POST", "/events.json", self.handle_create),
            ("GET", "/events.json", self.handle_find),
            ("GET", "/events/{event_id}.json", self.handle_get),
            ("DELETE", "/events/{event_id}.json", self.handle_delete),
            ("POST", "/batch/events.json", self.handle_batch),
            ("GET", "/stats.json", self.handle_stats),
            ("GET", "/plugins.json", self.handle_plugins),
            ("*", "/plugins/{tail:.*}", self.handle_plugin_rest),
            ("POST", "/webhooks/{name}.json", self.handle_webhook_post),
            ("GET", "/webhooks/{name}.json", self.handle_webhook_get),
            *metrics_routes(self.registry, default_registry()),
            *capacity_routes(),
            *history_routes(history_reader_factory(self.telemetry)),
        ], middleware=observability_middleware(self.registry,
                                               "event_server"))
        #: set to shut :func:`run_event_server` down
        self.stopped = asyncio.Event()

    async def start(self, host: str = "localhost",
                    port: int = DEFAULT_PORT, ssl_context=None) -> int:
        return await self._http.start(host, port, ssl_context=ssl_context)

    async def close(self) -> None:
        """Stop accepting, then flush every buffered event: accepted
        events are never dropped by a graceful shutdown."""
        await self._http.close()
        loop = asyncio.get_running_loop()
        if self.buffer is not None:
            await loop.run_in_executor(None, self.buffer.stop)
        if self.telemetry is not None:
            # last: the final drain persists what the shutdown emitted
            await loop.run_in_executor(None, self.telemetry.stop)
            self.telemetry = None

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

    def _ingest(self, status: int, reason: Optional[str] = None) -> None:
        """Count one event's outcome (``pio_event_ingest_total``) and,
        for a rejection, its reason (``pio_event_rejected_total``)."""
        self._ingest_total.inc(status=str(status))
        if reason is not None:
            self._rejected_total.inc(reason=reason)

    def _shed(self, bf: BufferFull) -> Tuple[int, Any, dict]:
        """Explicit load shedding: the ingest queue is at its bound."""
        self._ingest(429, "shed")
        return 429, {"message": str(bf)}, {"Retry-After":
                                           str(bf.retry_after)}

    def _storage_failed(self, e: StorageError) -> Tuple[int, Any]:
        # a buffered failure already spent its retries: retryable 503;
        # the direct path keeps the reference's 500
        status = 503 if self.buffer is not None else 500
        self._ingest(status, "storage_error")
        return status, {"message": str(e)}

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
            self._ingest(400, "invalid")
            return 400, {"message": str(e)}
        if auth.events and event.event not in auth.events:
            self._ingest(403, "forbidden")
            return 403, {"message": f"{event.event} events are not allowed"}
        blocked = self._blocked(auth, event)
        if blocked is not None:
            self._ingest(403, "blocked")
            return 403, {"message": blocked}
        try:
            event_id = (await self._insert([event], auth))[0]
        except BufferFull as bf:
            return self._shed(bf)
        except StorageError as e:
            return self._storage_failed(e)
        self._sniff(auth, event)
        if self.stats_enabled:
            self.stats.bookkeeping(auth.app_id, 201, event)
        self._ingest(201)
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
        self._batch_size.observe(len(body))
        results: List[Optional[dict]] = [None] * len(body)
        to_insert = []  # (index, event)
        for i, item in enumerate(body):
            try:
                event = Event.from_dict(item)
                validate_event(event)
            except (EventValidationError, TypeError, AttributeError) as e:
                self._ingest(400, "invalid")
                results[i] = {"status": 400, "message": str(e)}
                continue
            if auth.events and event.event not in auth.events:
                self._ingest(403, "forbidden")
                results[i] = {"status": 403, "message":
                              f"{event.event} events are not allowed"}
                continue
            blocked = self._blocked(auth, event)
            if blocked is not None:
                self._ingest(403, "blocked")
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
                    self._ingest(503, "storage_error")
                    results[i] = {"status": 503, "message": str(e)}
            else:
                for (i, event), event_id in zip(to_insert, ids):
                    self._ingest(201)
                    self._sniff(auth, event)
                    if self.stats_enabled:
                        self.stats.bookkeeping(auth.app_id, 201, event)
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

    async def handle_stats(self, req: Request):
        auth = await self._auth(req)
        if not self.stats_enabled:
            return 404, {"message": "To see stats, launch Event Server "
                                    "with --stats argument."}
        return 200, self.stats.get(auth.app_id)

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

    # -- webhooks (EventServer.scala:442-523) -------------------------------
    @staticmethod
    def _unsupported(name: str) -> Tuple[int, Any]:
        return 404, {"message": f"webhooks connection for {name} is not "
                                "supported."}

    async def handle_webhook_post(self, req: Request):
        auth = await self._auth(req)
        name = req.params["name"]
        connector = webhooks.get_connector(name)
        if connector is None:
            return self._unsupported(name)
        try:
            payload = req.form() if connector.form_based else req.json()
            event = connector.to_event(payload)
            validate_event(event)
        except Exception as e:      # the reference answers 400 for any
            self._ingest(400, "invalid")
            return 400, {"message": str(e)}
        try:
            event_id = (await self._insert([event], auth))[0]
        except BufferFull as bf:
            return self._shed(bf)
        except StorageError as e:
            return self._storage_failed(e)
        if self.stats_enabled:
            self.stats.bookkeeping(auth.app_id, 201, event)
        self._ingest(201)
        return 201, {"eventId": event_id}

    async def handle_webhook_get(self, req: Request):
        await self._auth(req)
        name = req.params["name"]
        if webhooks.get_connector(name) is None:
            return self._unsupported(name)
        return 200, {"message": f"webhooks connection for {name} is ok."}


def run_event_server(host: str = "localhost", port: int = DEFAULT_PORT,
                     on_ready=None, stats: bool = False) -> None:
    """Serve until SIGINT or SIGTERM, then drain the write buffer.
    ``on_ready(port)`` runs once the socket is bound. server.json (with
    its env) gives the ingest knobs, TLS and durable telemetry
    (``PIO_TELEMETRY=0`` off; the store ``event_server-<port>``)."""
    cfg = ServerConfig.load()
    registry = MetricsRegistry()
    telemetry = build_recorder("event_server", cfg.telemetry,
                               instance=str(port),
                               registries=[registry, default_registry()])
    serve_until_stopped(EventServer(ingest=cfg.ingest, stats=stats,
                                    registry=registry,
                                    telemetry=telemetry),
                        host, port, on_ready,
                        ssl_context=cfg.ssl_context())
