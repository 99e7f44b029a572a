"""Env-driven storage registry (port of the reference's
``storage/registry.py``, the Storage.scala:146-466 analog).

  * ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` — backend type of source <NAME>;
    the port has ``sqlite`` (every repository) and ``localfs`` / ``fs``
    (MODELDATA, local paths); the reference's other types raise
    ``NotImplementedError`` naming where they live;
  * ``PIO_STORAGE_SOURCES_<NAME>_PATH`` — the sqlite file, or the model
    directory;
  * ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}``
    — binds each repository to a source.

Without those variables everything lives in one sqlite file under
``$PIO_HOME`` (default ``~/.pio_tpu``), ``data/pio.db``, as in the
reference. Clients are created lazily and cached per source name;
:meth:`Storage.configure` overrides the environment and
:meth:`Storage.reset` drops the cache.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import StorageError

_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_([A-Z0-9_]+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

#: the reference's other source types and the module of each there
_NOT_PORTED = {
    "postgres": "storage/postgres_backend.py",
    "parquet": "storage/parquet_events.py",
    "evlog": "storage/evlog_backend.py",
}

#: data object kind -> sqlite backend class name
_SQLITE_KINDS = {
    "apps": "SqliteApps", "accesskeys": "SqliteAccessKeys",
    "channels": "SqliteChannels", "engineinstances": "SqliteEngineInstances",
    "releases": "SqliteReleases", "models": "SqliteModels",
    "events": "SqliteEvents",
}


def _parse_env(env: Dict[str, str]) -> Dict:
    sources: Dict[str, Dict[str, str]] = {}
    repos: Dict[str, Dict[str, str]] = {}
    for key, value in env.items():
        m = _SOURCE_RE.match(key)
        if m:
            sources.setdefault(m.group(1), {})[m.group(2)] = value
            continue
        m = _REPO_RE.match(key)
        if m:
            repos.setdefault(m.group(1), {})[m.group(2)] = value
    return {"sources": sources, "repositories": repos}


def default_config(home: Optional[str] = None) -> Dict:
    """Single-file sqlite under $PIO_HOME (or ~/.pio_tpu) for events and
    metadata, model blobs as files under ``models/`` beside it."""
    home = home or os.environ.get(
        "PIO_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu"))
    db = os.path.join(home, "data", "pio.db")
    return {
        "sources": {
            "SQLITE": {"TYPE": "sqlite", "PATH": db},
            "LOCALFS": {"TYPE": "localfs",
                        "PATH": os.path.join(home, "models")},
        },
        "repositories": {
            "METADATA": {"NAME": "pio_meta", "SOURCE": "SQLITE"},
            "EVENTDATA": {"NAME": "pio_event", "SOURCE": "SQLITE"},
            "MODELDATA": {"NAME": "pio_model", "SOURCE": "LOCALFS"},
        },
    }


class Storage:
    """Lazy, cached accessors for the data objects (Storage.scala:401-454)."""

    _lock = threading.RLock()
    _config: Optional[Dict] = None
    _clients: Dict[str, object] = {}
    _objects: Dict[str, object] = {}

    @classmethod
    def configure(cls, config: Dict) -> None:
        """Programmatic configuration; resets all cached clients."""
        with cls._lock:
            cls._close_clients()
            cls._config = config

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._close_clients()
            cls._config = None

    @classmethod
    def _close_clients(cls) -> None:
        for c in cls._clients.values():
            c.close()
        cls._clients = {}
        cls._objects = {}

    @classmethod
    def config(cls) -> Dict:
        if cls._config is None:
            parsed = _parse_env(dict(os.environ))
            if parsed["sources"] and parsed["repositories"]:
                cls._config = parsed
            else:
                cls._config = default_config()
        return cls._config

    @classmethod
    def _source(cls, repository: str):
        conf = cls.config()
        repo = conf["repositories"].get(repository)
        if not repo:
            raise StorageError(f"repository {repository} is not configured")
        source = conf["sources"].get(repo["SOURCE"])
        if not source:
            raise StorageError(
                f"source {repo['SOURCE']} (for repository {repository}) "
                "is not configured")
        return repo["SOURCE"], source

    @classmethod
    def _get(cls, repository: str, kind: str):
        key = f"{repository}:{kind}"
        with cls._lock:
            obj = cls._objects.get(key)
            if obj is not None:
                return obj
            name, source = cls._source(repository)
            stype = source.get("TYPE", "sqlite")
            if stype in ("localfs", "fs"):
                if kind != "models":
                    raise StorageError(
                        f"{stype} source {name} only supports MODELDATA")
                from predictionio_tpu_torch.storage.fs_models import FSModels
                from predictionio_tpu_torch.storage.localfs_models import (
                    LocalFSModels,
                )

                obj = (LocalFSModels if stype == "localfs" else FSModels)(
                    source.get("PATH") or os.path.join(
                        os.path.expanduser("~"), ".pio_tpu", "models"))
            elif stype == "sqlite":
                from predictionio_tpu_torch.storage import (
                    sqlite_backend as sb,
                )

                client = cls._clients.get(name)
                if client is None:
                    client = sb.SqliteClient(source.get("PATH", ":memory:"))
                    cls._clients[name] = client
                obj = getattr(sb, _SQLITE_KINDS[kind])(client)
            else:
                where = _NOT_PORTED.get(stype)
                if where is None:
                    raise StorageError(f"unknown storage type {stype!r} "
                                       f"for source {name}")
                raise NotImplementedError(
                    f"storage type {stype!r} (source {name}) is not ported "
                    f"to PyTorch yet: see predictionio_tpu/{where}")
            cls._objects[key] = obj
            return obj

    @classmethod
    def get_meta_data_apps(cls) -> base.Apps:
        return cls._get("METADATA", "apps")

    @classmethod
    def get_meta_data_access_keys(cls) -> base.AccessKeys:
        return cls._get("METADATA", "accesskeys")

    @classmethod
    def get_meta_data_channels(cls) -> base.Channels:
        return cls._get("METADATA", "channels")

    @classmethod
    def get_meta_data_engine_instances(cls) -> base.EngineInstances:
        return cls._get("METADATA", "engineinstances")

    @classmethod
    def get_meta_data_releases(cls) -> base.Releases:
        return cls._get("METADATA", "releases")

    @classmethod
    def get_model_data_models(cls) -> base.Models:
        return cls._get("MODELDATA", "models")

    @classmethod
    def get_events(cls) -> base.EventStore:
        """The event store."""
        return cls._get("EVENTDATA", "events")
