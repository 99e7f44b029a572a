"""The port's Event Server counts its ingest as the reference's does:
``pio_event_ingest_total{status}``, ``pio_event_rejected_total{reason}``
and ``pio_event_batch_size``.

Each case replays one request sequence against both servers, each on its
own sqlite store set up alike (``test_torch_event_server``'s ``stores``):
the reference's through aiohttp's test client, the port's over its
stdlib server. The statuses and the three series' exposition lines on
``/metrics`` must be equal. The first case is the reference's own
(``tests/test_obs_middleware.py::test_event_server_metrics_scrape``:
three events, an invalid one, a batch of four); the others reach each
remaining reason: ``forbidden`` (a key restricted to ``view``),
``blocked`` (an input blocker), ``shed`` (a full ingest queue) and
``storage_error`` (every write failed by ``storage/faults``'
``PIO_FAULT_ERROR_RATE``, through the write buffer and without it).
"""

import re

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer

from predictionio_tpu.obs.registry import MetricsRegistry as RefRegistry
from predictionio_tpu.server import plugins as ref_plugins
from predictionio_tpu.server.event_server import (
    create_event_server as ref_create_event_server,
)
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.utils.server_config import (
    IngestConfig as RefIngestConfig,
)
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.server import plugins as port_plugins
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import IngestConfig
from test_torch_event_server import (  # noqa: E402
    EV, KEY, RESTRICTED, _config, stores,
)

pytestmark = pytest.mark.anyio

__all__ = ["stores"]

SERIES = ("pio_event_ingest_total", "pio_event_rejected_total",
          "pio_event_batch_size")


def _series(text: str):
    """The three series' lines of an exposition (HELP, TYPE, samples,
    exemplars with their trace id and time masked)."""
    return sorted(re.sub(r'trace_id="[0-9a-f]+" (\S+) \S+$',
                         r"trace_id=<id> \1 <ts>", line)
                  for line in text.splitlines()
                  if any(name in line for name in SERIES))


def _blockers(mod):
    """A plugin context whose one input blocker rejects ``spam``."""
    class SpamBlocker(mod.EventServerPlugin):
        plugin_name = "spam"
        plugin_description = "rejects spam events"
        plugin_type = mod.EventServerPlugin.INPUT_BLOCKER

        def process(self, app_id, channel_id, event):
            if event.event == "spam":
                raise ValueError("spam events are blocked")

    ctx = mod.PluginContext()
    ctx.register(SpamBlocker())
    return ctx


def _post(key, body):
    return ("POST", f"/events.json?accessKey={key}", body)


def _batch(key, body):
    return ("POST", f"/batch/events.json?accessKey={key}", body)


CASES = {
    # the reference's own sequence (test_obs_middleware.py:150-190)
    "scrape": dict(requests=[_post(KEY, EV)] * 3 + [
        _post(KEY, {"event": "view"}),
        _batch(KEY, [dict(EV, entityId=f"u{i}") for i in range(4)])]),
    "forbidden": dict(requests=[
        _post(RESTRICTED, dict(EV, event="buy")),
        _batch(RESTRICTED, [EV, dict(EV, event="buy"),
                            dict(EV, event="like")])]),
    "blocked": dict(requests=[
        _post(KEY, dict(EV, event="spam")),
        _batch(KEY, [EV, dict(EV, event="spam"), {"event": "view"}])],
        plugins=True),
    "shed": dict(requests=[
        _batch(KEY, [EV, dict(EV, entityId="u2")]),
        _post(KEY, {"event": "view"})], ingest=dict(queue_max=1)),
    "storage_error_buffered": dict(requests=[
        _post(KEY, EV),
        _batch(KEY, [EV, {"event": "view"}, dict(EV, entityId="u2")])],
        ingest=dict(retries=1, backoff_s=0.0), faults=True),
    "storage_error_direct": dict(requests=[
        _post(KEY, EV),
        _batch(KEY, [EV, dict(EV, entityId="u2")])],
        ingest=dict(buffer=False), faults=True),
}


@pytest.mark.parametrize("name", list(CASES))
async def test_ingest_series_match_reference(stores, monkeypatch, name):
    case = CASES[name]
    if case.get("faults"):
        # storage/faults wraps each store's events at its next cache fill
        monkeypatch.setenv("PIO_FAULT_ERROR_RATE", "1")
        RefStorage.configure(_config(stores["ref"]))
        Storage.configure(_config(stores["port"]))
    ingest = case.get("ingest", {})
    plugins = case.get("plugins", False)
    ref_client = TestClient(TestServer(ref_create_event_server(
        stats=True, registry=RefRegistry(),
        ingest=RefIngestConfig(**ingest),
        plugin_context=_blockers(ref_plugins) if plugins else None)))
    await ref_client.start_server()
    port_server = EventServer(
        ingest=IngestConfig(**ingest), stats=True,
        registry=MetricsRegistry(),
        plugin_context=_blockers(port_plugins) if plugins else None)
    port = await port_server.start("127.0.0.1", 0)
    session = aiohttp.ClientSession()

    async def ref_call(method, path, body=None):
        resp = await ref_client.request(method, path, json=body)
        return resp.status, await resp.text()

    async def port_call(method, path, body=None):
        async with session.request(method, f"http://127.0.0.1:{port}{path}",
                                   json=body) as resp:
            return resp.status, await resp.text()

    got = {}
    try:
        for side, call in (("ref", ref_call), ("port", port_call)):
            statuses = [(await call(*r))[0] for r in case["requests"]]
            status, text = await call("GET", "/metrics")
            assert status == 200
            got[side] = (statuses, _series(text))
    finally:
        await session.close()
        await port_server.close()
        await ref_client.close()
    assert got["port"] == got["ref"]
    lines = got["port"][1]
    assert any(line.startswith("pio_event_batch_size_count")
               for line in lines)
    if name == "scrape":
        # the values the reference's own test holds
        assert 'pio_event_ingest_total{status="201"} 7' in lines
        assert 'pio_event_ingest_total{status="400"} 1' in lines
        assert 'pio_event_rejected_total{reason="invalid"} 1' in lines
        assert "pio_event_batch_size_count 1" in lines
        assert 'pio_event_batch_size_bucket{le="5"} 1' in lines
    else:
        reason = name.split("_buffered")[0].split("_direct")[0]
        assert any(line.startswith(
            f'pio_event_rejected_total{{reason="{reason}"}}')
            for line in lines), lines
