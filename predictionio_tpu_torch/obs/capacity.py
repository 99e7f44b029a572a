"""Device-memory capacity ledger: where device (and host) bytes live
(the reference's ``obs/capacity.py``).

* **per-unit residency**: for every :class:`~predictionio_tpu_torch.
  deploy.warm.ServingUnit`, the model's device-resident item factors
  (``ALSModel._resident``), the quantized scorer's device residency
  (its int8 tiles and f32 scales, counted from the tensors), the
  two-stage rotation, and (the port's addition) ``hostBytes``: the
  arrays the scorer keeps on the host, the f32 rescore copy and the
  rotation, which the reference holds on the device;
* **process level**: the CUDA allocator's live bytes, allocations and
  high-water mark (``obs/device_stats``), plus a sampled host VmRSS;
* surfaced as gauges (``pio_capacity_*``), at ``GET /capacity.json`` on
  both servers, and via ``pio capacity``.

Import-light by design: no torch import here (``obs/device_stats``
reads the allocator only once something else initialised CUDA), so
the CLI can format a capacity document without server deps.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

from predictionio_tpu_torch.obs import device_stats
from predictionio_tpu_torch.obs.registry import MetricsRegistry, default_registry

logger = logging.getLogger("pio.obs")

CAPACITY_PATH = "/capacity.json"

DEVICE_BYTES_GAUGE = "pio_capacity_device_bytes"
DEVICE_WATERMARK_GAUGE = "pio_capacity_device_watermark_bytes"
HOST_RSS_GAUGE = "pio_capacity_host_rss_bytes"
UNIT_RESIDENT_GAUGE = "pio_capacity_unit_resident_bytes"

#: host-RSS sampling window — /proc reads are cheap but not free, and
#: the telemetry loop can scrape sub-second
RSS_TTL_S = 1.0
_rss_cache = (float("-inf"), 0.0)   # (monotonic ts, bytes)


def _read_rss_bytes() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except (OSError, ValueError, IndexError):
        pass
    try:    # non-procfs fallback: peak RSS is the best signal available
        import resource

        return float(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0
    except Exception:
        return 0.0


def host_rss_bytes(ttl_s: float = RSS_TTL_S) -> float:
    """Sampled resident-set size of this process (bytes), memoized for
    `ttl_s` (benign races: worst case two samples in a window)."""
    global _rss_cache
    now = time.monotonic()
    ts, value = _rss_cache
    if now - ts < ttl_s:
        return value
    value = _read_rss_bytes()
    _rss_cache = (now, value)
    return value


# ---------------------------------------------------------------------------
# per-unit residency
# ---------------------------------------------------------------------------

def _nbytes(a) -> int:
    return int(a.nbytes) if a is not None else 0


def model_capacity(model) -> Dict:
    """One model's residency breakdown, counted from the tensors and
    arrays it holds (a scorer is built lazily: a unit that never scored
    holds none). ``residentBytes`` is the device bytes: the item
    factors plus the scorer's tiles and scales, or what a model without
    a scorer reports through ``device_bytes()`` (a forest's thresholds
    and node arrays, naive Bayes' parameters and resident X) as its
    ``modelFactorBytes``."""
    entry = {"model": type(model).__name__,
             "modelFactorBytes": 0, "scorerFactorBytes": 0,
             "shortlistBytes": 0, "exactBytes": 0, "residentBytes": 0,
             "hostBytes": 0}
    resident = getattr(model, "_resident", None)
    if resident is not None:
        entry["modelFactorBytes"] = _nbytes(resident[1])
    device_bytes = getattr(model, "device_bytes", None)
    if callable(device_bytes):
        entry["modelFactorBytes"] += int(device_bytes())
    cached = getattr(model, "_scorer_cache", None)
    if cached is not None:
        scorer = cached[2]
        status = scorer.status()
        entry["scorer"] = status
        entry["exactBytes"] = int(status.get("exactBytes", 0))
        entry["scorerFactorBytes"] = (_nbytes(scorer._tiles)
                                      + _nbytes(scorer._scales))
        entry["shortlistBytes"] = _nbytes(scorer._rotation)
        entry["hostBytes"] = (_nbytes(scorer._v_host)
                              + entry["shortlistBytes"])
    entry["residentBytes"] = (entry["modelFactorBytes"]
                              + entry["scorerFactorBytes"])
    return entry


def unit_capacity(unit, role: str) -> Dict:
    """Residency roll-up for one serving unit (active/standby/canary).
    ``scorerBytes`` is the sum of the scorers' device bytes, which is
    the ``factorBytes`` /deploy/status.json echoes, so the two endpoints
    can be cross-checked."""
    result = getattr(unit, "result", None)
    models = [model_capacity(m)
              for m in (getattr(result, "models", ()) or ())]
    instance = getattr(unit, "instance", None)
    return {
        "role": role,
        "engineInstanceId": getattr(instance, "id", None),
        "release": getattr(unit, "release_version", None),
        "scorerBytes": sum(m["scorerFactorBytes"] for m in models),
        "residentBytes": sum(m["residentBytes"] for m in models),
        "models": models,
    }


def capacity_document(units_fn: Optional[Callable[[], Iterable[Dict]]]
                      = None) -> Dict:
    """The /capacity.json body: process-level device/host footprint plus
    per-unit residency when the server has units to report."""
    device_bytes, device_arrays = device_stats.live_buffer_stats()
    doc = {
        "ts": time.time(),
        "process": {
            "deviceBytes": device_bytes,
            "deviceArrays": device_arrays,
            "deviceWatermarkBytes": device_stats.device_watermark_bytes(),
            "hostRssBytes": host_rss_bytes(),
        },
        "units": [],
    }
    if units_fn is not None:
        try:
            doc["units"] = list(units_fn())
        except Exception:
            logger.exception("capacity: reading the serving units failed")
            doc["units"] = []
    return doc


# ---------------------------------------------------------------------------
# gauges + route
# ---------------------------------------------------------------------------

def register_capacity_metrics(registry: MetricsRegistry = None,
                              units_fn: Optional[Callable] = None,
                              labelnames: Sequence[str] = ("role",)
                              ) -> MetricsRegistry:
    """Idempotently register the capacity gauges; with a `units_fn`
    (query server) the per-unit resident gauge reports one sample per
    unit role — role, not instance id, keeps the cardinality fixed. A
    multi-tenant host labels each sample with its tenant too
    (``labelnames=("tenant", "role")``; each unit dict carries the
    keys), after unregistering the gauge its tenants' servers made."""
    reg = registry or default_registry()
    reg.gauge_callback(
        DEVICE_BYTES_GAUGE,
        "Bytes held by live device tensors (the CUDA allocator's count)",
        lambda: device_stats.live_buffer_stats()[0])
    reg.gauge_callback(
        DEVICE_WATERMARK_GAUGE,
        "High-water mark of live device-tensor bytes since process start",
        device_stats.device_watermark_bytes)
    reg.gauge_callback(
        HOST_RSS_GAUGE, "Sampled host resident-set size", host_rss_bytes)
    if units_fn is not None:
        def _unit_samples():
            return [({k: str(u.get(k, "?")) for k in labelnames},
                     float(u.get("residentBytes", 0)))
                    for u in units_fn()]
        reg.gauge_callback(
            UNIT_RESIDENT_GAUGE,
            "Device-resident bytes per serving unit (factors + quantized "
            "scorer)",
            _unit_samples, labelnames=tuple(labelnames))
    return reg


def capacity_routes(units_fn: Optional[Callable] = None) -> list:
    """``GET /capacity.json`` as a ``server/http`` route."""

    async def handle_capacity(_req):
        return 200, capacity_document(units_fn)

    return [("GET", CAPACITY_PATH, handle_capacity)]
