"""Component parameters and their JSON extraction (port of the
reference's ``core/params.py``).

Engine variant JSON keeps the reference's engine.json schema:

    {
      "id": "default",
      "engineFactory": "mypkg.engine:factory",
      "datasource": {"params": {"appName": "MyApp1"}},
      "preparator": {"params": {}},
      "algorithms": [{"name": "als", "params": {...}}],
      "serving": {"params": {...}}
    }

A deploy reads only the algorithms and serving sections, so a variant
without a ``datasource`` section parses (its data source params are then
None); ``pio train`` needs it.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Params:
    """Marker base for component params. Subclasses are normally
    dataclasses; plain dicts are also accepted anywhere Params are."""


def params_to_json(params: Any) -> Any:
    """Params (dataclass | dict | None) -> JSON value."""
    if params is None:
        return {}
    if dataclasses.is_dataclass(params) and not isinstance(params, type):
        return dataclasses.asdict(params)
    if isinstance(params, dict):
        return params
    raise TypeError(
        f"cannot serialize params of type {type(params).__name__}")


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
    """EngineParams.scala:35 — named params for each DASE component.
    Component names select among an Engine's registered classes; ""
    selects the single/default one."""

    data_source_name: str = ""
    data_source_params: Any = None
    preparator_name: str = ""
    preparator_params: Any = None
    #: list of (algorithm name, params)
    algorithm_params_list: Sequence[Tuple[str, Any]] = ()
    serving_name: str = ""
    serving_params: Any = None

    def to_json_dict(self) -> Dict[str, Any]:
        """engineParamsToJson parity (JsonExtractor.scala:95): the
        engine.json sections of these params (``best.json``)."""
        return {
            "datasource": {"name": self.data_source_name,
                           "params": params_to_json(self.data_source_params)},
            "preparator": {"name": self.preparator_name,
                           "params": params_to_json(self.preparator_params)},
            "algorithms": [
                {"name": name, "params": params_to_json(p)}
                for name, p in self.algorithm_params_list],
            "serving": {"name": self.serving_name,
                        "params": params_to_json(self.serving_params)},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)


def engine_params_from_json(
    data: Dict[str, Any],
    data_source_params_class: Optional[type] = None,
    preparator_params_class: Optional[type] = None,
    algorithm_params_classes: Optional[Dict[str, type]] = None,
    serving_params_class: Optional[type] = None,
) -> EngineParams:
    """jValueToEngineParams parity (Engine.scala:355-418); the datasource
    and preparator sections are parsed when present."""
    def _component(key: str, cls: Optional[type], optional: bool):
        node = data.get(key)
        if node is None and optional:
            return "", None
        node = node or {}
        if not isinstance(node, dict):
            raise ValueError(f"{key} must be an object")
        return node.get("name", ""), params_from_json(node.get("params"),
                                                      cls)

    ds_name, ds_params = _component("datasource", data_source_params_class,
                                    True)
    p_name, p_params = _component("preparator", preparator_params_class,
                                  True)
    s_name, s_params = _component("serving", serving_params_class, False)

    algo_list: List[Tuple[str, Any]] = []
    for node in data.get("algorithms") or []:
        name = node.get("name", "")
        cls = (algorithm_params_classes or {}).get(name)
        algo_list.append((name, params_from_json(node.get("params"), cls)))
    return EngineParams(
        data_source_name=ds_name, data_source_params=ds_params,
        preparator_name=p_name, preparator_params=p_params,
        algorithm_params_list=algo_list,
        serving_name=s_name, serving_params=s_params)
