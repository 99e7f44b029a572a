"""Server plugin registries (port of the reference's
``server/plugins.py``; EventServerPlugin.scala, EngineServerPlugin.scala):

  * :class:`EventServerPlugin` — input blockers (synchronous, may reject
    an event by raising) and input sniffers (observers after the insert)
    on the event server's ingest routes;
  * :class:`EngineServerPlugin` — output blockers (synchronous
    prediction transforms) and output sniffers on the query server's
    answer path.

Plugins are registered explicitly (:meth:`PluginContext.register`) or
discovered through setuptools entry points. The port reads its own
groups, ``predictionio_tpu_torch.eventserver_plugins`` and
``predictionio_tpu_torch.engineserver_plugins``: a plugin written for
the JAX package subclasses that package's classes, which the port does
not import.
"""

from __future__ import annotations

import abc
import logging
from typing import Dict, List, Optional

from predictionio_tpu_torch.data.event import Event

logger = logging.getLogger("pio.torch.plugins")

#: the entry-point groups the servers load plugins from
EVENTSERVER_GROUP = "predictionio_tpu_torch.eventserver_plugins"
ENGINESERVER_GROUP = "predictionio_tpu_torch.engineserver_plugins"


class EventServerPlugin(abc.ABC):
    """Input blocker or sniffer on the ingest path."""

    INPUT_BLOCKER = "inputblocker"
    INPUT_SNIFFER = "inputsniffer"

    plugin_name: str = ""
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    @abc.abstractmethod
    def process(self, app_id: int, channel_id: Optional[int],
                event: Event) -> None:
        """Blockers raise to reject the event; sniffers observe."""

    def handle_rest(self, app_id: int, channel_id: Optional[int],
                    args: List[str]) -> dict:
        return {}


class EngineServerPlugin(abc.ABC):
    """Output blocker or sniffer on the query path."""

    OUTPUT_BLOCKER = "outputblocker"
    OUTPUT_SNIFFER = "outputsniffer"

    plugin_name: str = ""
    plugin_description: str = ""
    plugin_type: str = OUTPUT_SNIFFER

    @abc.abstractmethod
    def process(self, engine_instance, query: dict, prediction: dict) -> dict:
        """Blockers return a (possibly modified) prediction; sniffers
        observe and their return value is ignored."""

    def handle_rest(self, args: List[str]) -> dict:
        return {}


class PluginContext:
    """The registered plugins, split by type."""

    def __init__(self, entry_point_group: Optional[str] = None):
        self.input_blockers: Dict[str, EventServerPlugin] = {}
        self.input_sniffers: Dict[str, EventServerPlugin] = {}
        self.output_blockers: Dict[str, EngineServerPlugin] = {}
        self.output_sniffers: Dict[str, EngineServerPlugin] = {}
        if entry_point_group:
            self._load_entry_points(entry_point_group)

    def register(self, plugin) -> None:
        if isinstance(plugin, EventServerPlugin):
            target = (self.input_blockers
                      if plugin.plugin_type == EventServerPlugin.INPUT_BLOCKER
                      else self.input_sniffers)
        elif isinstance(plugin, EngineServerPlugin):
            target = (self.output_blockers
                      if plugin.plugin_type == EngineServerPlugin.OUTPUT_BLOCKER
                      else self.output_sniffers)
        else:
            raise TypeError(f"not a plugin: {plugin!r}")
        target[plugin.plugin_name] = plugin

    def _load_entry_points(self, group: str) -> None:
        try:
            from importlib.metadata import entry_points

            for ep in entry_points(group=group):
                self.register(ep.load()())
        except Exception:  # discovery must never break a server
            logger.exception("plugin discovery in %s failed", group)

    def describe(self) -> dict:
        def _desc(plugins):
            return {name: {"name": p.plugin_name,
                           "description": p.plugin_description,
                           "class": type(p).__qualname__}
                    for name, p in plugins.items()}
        return {
            "inputblockers": _desc(self.input_blockers),
            "inputsniffers": _desc(self.input_sniffers),
            "outputblockers": _desc(self.output_blockers),
            "outputsniffers": _desc(self.output_sniffers),
        }
