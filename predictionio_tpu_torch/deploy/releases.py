"""Release manifests: digests, registration, selection (port of the
reference's ``deploy/releases.py``).

A release is the deployable identity of one train run. Two digests say
whether anything changed without loading the blob:

  * ``params_digest`` — sha256 over the EngineInstance's four params
    JSON strings (``run_train`` writes them with ``sort_keys=True``, so
    the digest is stable across processes and equal to the reference's
    for the same instance);
  * ``model_digest`` — sha256 of the serialized model blob.

``record_release`` is called by ``workflow.train.run_train`` once the
instance is COMPLETED; a failure is logged, never raised — a missing
manifest must not fail a finished train.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Optional

from predictionio_tpu_torch.storage.base import (
    EngineInstance, Release, Releases,
)

logger = logging.getLogger("pio.torch.deploy")


def release_to_json(r: Release) -> dict:
    """The wire shape of a release manifest (``GET /releases.json``)."""
    return {
        "id": r.id, "version": r.version, "status": r.status,
        "engineId": r.engine_id,
        "engineVersion": r.engine_version,
        "engineVariant": r.engine_variant,
        "engineInstanceId": r.instance_id,
        "paramsDigest": r.params_digest, "modelDigest": r.model_digest,
        "modelSizeBytes": r.model_size_bytes,
        "createdTime": r.created_time.isoformat(),
        "trainSeconds": r.train_seconds, "batch": r.batch,
        "history": r.history,
    }


def params_digest(instance: EngineInstance) -> str:
    """Content digest of the engine params that produced the instance."""
    h = hashlib.sha256()
    for part in (instance.data_source_params, instance.preparator_params,
                 instance.algorithms_params, instance.serving_params):
        h.update((part or "").encode())
        h.update(b"\x00")
    return h.hexdigest()


def model_digest(blob: Optional[bytes]) -> str:
    """Content digest of the serialized model blob ('' without one)."""
    if not blob:
        return ""
    return hashlib.sha256(blob).hexdigest()


def record_release(instance: EngineInstance, train_seconds: float,
                   blob: Optional[bytes] = None) -> Optional[Release]:
    """Register a COMPLETED instance as its variant's next release.
    Returns the inserted Release, or None when registration failed."""
    from predictionio_tpu_torch.storage.registry import Storage

    release = Release(
        engine_id=instance.engine_id,
        engine_version=instance.engine_version,
        engine_variant=instance.engine_variant,
        instance_id=instance.id,
        params_digest=params_digest(instance),
        model_digest=model_digest(blob),
        model_size_bytes=len(blob) if blob else 0,
        status="REGISTERED",
        train_seconds=train_seconds,
        batch=instance.batch,
        history=[{"status": "REGISTERED",
                  "timeMs": int(time.time() * 1000),
                  "reason": "train completed"}],
    )
    try:
        Storage.get_meta_data_releases().insert(release)
    except Exception:
        logger.exception("release registration failed for instance %s",
                         instance.id)
        return None
    logger.info("registered release v%d (%s) for %s/%s", release.version,
                release.id, release.engine_id, release.engine_variant)
    return release


def release_of_instance(releases: Releases,
                        instance: EngineInstance) -> Optional[Release]:
    """The release registered for an instance, if any."""
    for r in releases.get_for_variant(instance.engine_id,
                                      instance.engine_version,
                                      instance.engine_variant):
        if r.instance_id == instance.id:
            return r
    return None


def resolve_release(releases: Releases, engine_id: str, engine_version: str,
                    engine_variant: str,
                    selector: Optional[str] = None) -> Optional[Release]:
    """A release selector — an id, a version (``"3"``) or ``"v3"`` — to
    its manifest. None picks the newest release of the variant that was
    not ROLLED_BACK (a rejected release comes back only by an explicit
    selector). An id of another variant resolves to None."""
    if selector is None or selector == "":
        for r in releases.get_for_variant(engine_id, engine_version,
                                          engine_variant):
            if r.status != "ROLLED_BACK":
                return r
        return None
    release = releases.get(selector)
    if release is not None:
        if (release.engine_id, release.engine_version,
                release.engine_variant) != (engine_id, engine_version,
                                            engine_variant):
            return None
        return release
    raw = selector[1:] if selector[:1] in ("v", "V") else selector
    try:
        version = int(raw)
    except ValueError:
        return None
    return releases.get_by_version(engine_id, engine_version,
                                   engine_variant, version)
