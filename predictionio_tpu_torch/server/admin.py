"""Admin REST API, port 7071 (port of the reference's
``server/admin.py``; AdminAPI.scala:45-129 and its CommandClient):

  GET    /                      -> {"status": "alive"}
  GET    /cmd/app               -> the apps and their keys
  POST   /cmd/app               -> create an app (body {"name", "id"?,
                                   "description"?})
  DELETE /cmd/app/<name>        -> delete the app, its channels, keys
                                   and events
  DELETE /cmd/app/<name>/data   -> wipe the app's default channel
  GET    /cmd/releases          -> every release manifest;
                                   ?engineId=&engineVariant= filter
  GET    /cmd/slo               -> this host's server.json SLO spec and,
                                   with ?targets=host:port[,...], each
                                   query server's live /slo.json

Every request runs under the observability middleware; ``/metrics``,
``/metrics.json``, ``/debug/traces.json``, ``/capacity.json`` and
``/history/*.json`` (over the merged telemetry stores of the host) are
served as on the other servers. The HTTP layer is the port's stdlib one
(``server/http``); :func:`run_admin_server` listens over TLS when
server.json turns it on. The targets of ``/cmd/slo`` are read over
plain HTTP through ``server/http_client``, one retry each, at once.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

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
    HttpServer, Request, serve_until_stopped,
)
from predictionio_tpu_torch.storage.base import AccessKey, App
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import ServerConfig

logger = logging.getLogger("pio.torch.admin")

DEFAULT_PORT = 7071
#: the most ``/cmd/slo`` targets read at once
MAX_SLO_TARGETS = 32


async def _run(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


async def handle_root(_req: Request):
    return 200, {"status": "alive"}


async def handle_app_list(_req: Request):
    def _list():
        keys = Storage.get_meta_data_access_keys()
        return [{"name": a.name, "id": a.id,
                 "accessKeys": [k.key for k in keys.get_by_appid(a.id)]}
                for a in Storage.get_meta_data_apps().get_all()]
    return 200, {"status": 1, "apps": await _run(_list)}


async def handle_app_new(req: Request):
    try:
        body = req.json()
        name = body["name"]
    except Exception:
        return 400, {"status": 0, "message": "body must be JSON with a name"}

    def _create():
        apps = Storage.get_meta_data_apps()
        if apps.get_by_name(name):
            return None
        app_id = apps.insert(App(id=int(body.get("id") or 0), name=name,
                                 description=body.get("description")))
        if app_id is None:
            return None
        Storage.get_events().init_channel(app_id)
        key = Storage.get_meta_data_access_keys().insert(
            AccessKey(key="", appid=app_id, events=()))
        return app_id, key

    out = await _run(_create)
    if out is None:
        return 409, {"status": 0, "message": f"App {name} already exists."}
    app_id, key = out
    return 201, {"status": 1, "id": app_id, "name": name, "accessKey": key}


def delete_app(name: str) -> bool:
    """Drop the app's channels (their events first), its default
    channel's events, its keys and the app; False if there is none."""
    apps = Storage.get_meta_data_apps()
    app = apps.get_by_name(name)
    if app is None:
        return False
    events = Storage.get_events()
    channels = Storage.get_meta_data_channels()
    for c in channels.get_by_appid(app.id):
        events.remove_channel(app.id, c.id)
        channels.delete(c.id)
    events.remove_channel(app.id)
    keys = Storage.get_meta_data_access_keys()
    for k in keys.get_by_appid(app.id):
        keys.delete(k.key)
    apps.delete(app.id)
    return True


def wipe_app_data(name: str) -> bool:
    """Empty the app's default channel; False if there is no app."""
    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        return False
    events = Storage.get_events()
    events.remove_channel(app.id)
    events.init_channel(app.id)
    return True


async def handle_app_delete(req: Request):
    name = req.params["name"]
    if await _run(delete_app, name):
        return 200, {"status": 1, "message": f"App {name} deleted."}
    return 404, {"status": 0, "message": f"App {name} does not exist."}


async def handle_app_data_delete(req: Request):
    name = req.params["name"]
    if await _run(wipe_app_data, name):
        return 200, {"status": 1, "message": f"Data of app {name} deleted."}
    return 404, {"status": 0, "message": f"App {name} does not exist."}


async def handle_releases(req: Request):
    """Every engine variant's release manifests (the query server's
    ``/releases.json`` is one variant's)."""
    from predictionio_tpu_torch.deploy.releases import release_to_json

    engine_id = req.query.get("engineId")
    variant = req.query.get("engineVariant")

    def _list():
        return [release_to_json(r)
                for r in Storage.get_meta_data_releases().get_all()
                if (not engine_id or r.engine_id == engine_id)
                and (not variant or r.engine_variant == variant)]

    return 200, {"status": 1, "releases": await _run(_list)}


async def handle_slo(req: Request):
    """The host's configured objectives and, for ``?targets=``, each
    query server's ``/slo.json`` (a target that fails twice answers
    ``{"error": ...}``); ``breached`` names the breached targets."""
    from predictionio_tpu_torch.obs.slo import slo_spec_from_server_json
    from predictionio_tpu_torch.server.http_client import HttpClient
    from predictionio_tpu_torch.utils.retry import (
        RetryPolicy, retry_call_async,
    )

    spec = slo_spec_from_server_json()
    out = {
        "status": 1,
        "spec": ({
            "objectives": [{
                "name": o.name, "kind": o.kind,
                "thresholdS": o.threshold_s, "budget": o.budget}
                for o in spec.objectives],
            "windows": [{"seconds": w.seconds,
                         "burnThreshold": w.burn_threshold}
                        for w in spec.windows],
            "evalIntervalS": spec.eval_interval_s,
        } if spec is not None else None),
    }
    targets = [t.strip() for t in req.query.get("targets", "").split(",")
               if t.strip()][:MAX_SLO_TARGETS]
    if targets:
        policy = RetryPolicy(retries=1, backoff_s=0.1, backoff_cap_s=0.5)
        client = HttpClient()

        async def _get(target):
            resp = await client.request("GET", f"http://{target}/slo.json",
                                        timeout=5.0)
            return resp.json()

        async def _fetch(target):
            try:
                return target, await retry_call_async(
                    _get, (target,), policy=policy)
            except Exception as e:      # noqa: BLE001 — reported per target
                return target, {"error": str(e)}

        try:
            fleet = dict(await asyncio.gather(*[_fetch(t)
                                                for t in targets]))
        finally:
            await client.close()
        out["fleet"] = fleet
        out["breached"] = [t for t, s in fleet.items()
                           if isinstance(s, dict) and s.get("breached")]
    return 200, out


class AdminServer:
    """``start`` binds on the running loop and returns the port;
    ``close`` stops it (and the telemetry it owns); :func:`run_admin_server`
    is the blocking form."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 telemetry=None, history_root: Optional[str] = None):
        self.registry = registry or MetricsRegistry()
        self.telemetry = telemetry
        register_capacity_metrics(self.registry)
        self._http = HttpServer([
            ("GET", "/", handle_root),
            ("GET", "/cmd/app", handle_app_list),
            ("POST", "/cmd/app", handle_app_new),
            ("DELETE", "/cmd/app/{name}", handle_app_delete),
            ("DELETE", "/cmd/app/{name}/data", handle_app_data_delete),
            ("GET", "/cmd/releases", handle_releases),
            ("GET", "/cmd/slo", handle_slo),
            *capacity_routes(),
            *metrics_routes(self.registry, default_registry()),
            # the fleet's history: the merged per-process telemetry
            # stores under the root
            *history_routes(history_reader_factory(telemetry,
                                                   root=history_root)),
        ], middleware=observability_middleware(self.registry, "admin"))
        self.stopped = asyncio.Event()

    async def start(self, host: str = "localhost", port: int = DEFAULT_PORT,
                    ssl_context=None) -> int:
        return await self._http.start(host, port, ssl_context=ssl_context)

    async def close(self) -> None:
        await self._http.close()
        if self.telemetry is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self.telemetry.stop)
            self.telemetry = None


def create_admin_server(registry: Optional[MetricsRegistry] = None,
                        telemetry=None,
                        history_root: Optional[str] = None) -> AdminServer:
    return AdminServer(registry, telemetry=telemetry,
                       history_root=history_root)


def run_admin_server(host: str = "localhost", port: int = DEFAULT_PORT,
                     on_ready=None) -> None:
    """Serve until SIGINT or SIGTERM; server.json gives TLS and the
    telemetry (the store ``admin-<port>``, whose root ``/history`` reads).
    ``on_ready(port)`` runs once the socket is bound."""
    cfg = ServerConfig.load()
    registry = MetricsRegistry()
    telemetry = build_recorder("admin", cfg.telemetry, instance=str(port),
                               registries=[registry, default_registry()])
    serve_until_stopped(
        create_admin_server(registry, telemetry=telemetry,
                            history_root=cfg.telemetry.root_dir()),
        host, port, on_ready, ssl_context=cfg.ssl_context())
