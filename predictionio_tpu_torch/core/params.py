"""Component parameters and their JSON extraction (the serving subset of
the reference's ``core/params.py``).

Engine variant JSON keeps the reference's engine.json schema; the port
reads its ``algorithms`` and ``serving`` sections (the data source and
preparator sections belong to training, a later slice):

    {
      "id": "default",
      "engineFactory": "mypkg.engine:factory",
      "algorithms": [{"name": "als", "params": {...}}],
      "serving": {"params": {...}}
    }
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Params:
    """Marker base for component params. Subclasses are normally
    dataclasses; plain dicts are also accepted anywhere Params are."""


def _snake(name: str) -> str:
    """camelCase -> snake_case (appName -> app_name)."""
    return re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()


def params_from_json(data: Any, params_class: Optional[type] = None) -> Any:
    """JSON value -> params_class instance (or plain dict when no class).

    camelCase keys map onto the snake_case dataclass fields, as do
    per-class `json_aliases` (e.g. ALS's "lambda" -> reg). Unknown keys
    raise, which catches typo'd hyperparameters."""
    if data is None:
        data = {}
    if params_class is None:
        return dict(data)
    if not dataclasses.is_dataclass(params_class):
        return params_class(**data)
    field_names = {f.name for f in dataclasses.fields(params_class)}
    aliases = getattr(params_class, "json_aliases", {})
    mapped = {}
    sources = {}
    unknown = []
    for key, value in dict(data).items():
        name = aliases.get(key, key)
        if name not in field_names:
            name = _snake(name)
        if name in field_names:
            if name in mapped:
                raise ValueError(
                    f"parameters {sources[name]!r} and {key!r} both set "
                    f"field {name!r} of {params_class.__name__}")
            mapped[name] = value
            sources[name] = key
        else:
            unknown.append(key)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)} for "
            f"{params_class.__name__}; expected among {sorted(field_names)}")
    return params_class(**mapped)


@dataclasses.dataclass
class EngineParams:
    """Named params of the serving components: the algorithms (a list of
    (name, params)) and the serving component."""

    algorithm_params_list: Sequence[Tuple[str, Any]] = ()
    serving_name: str = ""
    serving_params: Any = None


def engine_params_from_json(
    data: Dict[str, Any],
    algorithm_params_classes: Optional[Dict[str, type]] = None,
    serving_params_class: Optional[type] = None,
) -> EngineParams:
    """The ``algorithms`` and ``serving`` sections of an engine.json."""
    node = data.get("serving") or {}
    if not isinstance(node, dict):
        raise ValueError("serving must be an object")
    s_name = node.get("name", "")
    s_params = params_from_json(node.get("params"), serving_params_class)

    algo_list: List[Tuple[str, Any]] = []
    for node in data.get("algorithms") or []:
        name = node.get("name", "")
        cls = (algorithm_params_classes or {}).get(name)
        algo_list.append((name, params_from_json(node.get("params"), cls)))
    return EngineParams(algorithm_params_list=algo_list,
                        serving_name=s_name, serving_params=s_params)
