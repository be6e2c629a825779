"""Extension (plugin) hook API and inter-plugin message bus.

A copy of the hook surface of ``octproz_tpu/plugins.py`` (numpy only), the
reference DevKit's plugin surface:

* :class:`Extension` mirrors ``Extension`` (octproz_devkit/src/extension.h:
  75-126): activate/deactivate lifecycle, ``raw_data_received`` /
  ``processed_data_received`` data feeds with the same
  (buffer, bitdepth, samples_per_line, ascans_per_bscan, bscans_per_buffer,
  buffers_per_volume, current_buffer_nr) signature, and grab-permission
  flags so inactive extensions cost nothing (extension.h:88-89,139-147).
* :class:`MessageBus` mirrors ``PluginMessageBus`` (octproz_project/octproz/
  src/pluginmessagebus.{h,cpp}): named command routing + broadcast.
* :class:`ExtensionManager` mirrors ``ExtensionManager``
  (src/extensionmanager.cpp:68-81): registry + wiring of the data feeds.

The streaming runtime invokes the hooks synchronously on its host loop with
numpy arrays.  Plugin loading (module specs, entry points, the plugin
context) is not ported yet (ROADMAP.md Queue 1, A12).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .params import AcqParams


class Plugin:
    """Base plugin: settings round-trip + command receipt
    (octproz_devkit/src/plugin.h:43-51)."""

    name: str = "plugin"

    def __init__(self) -> None:
        self.settings: Dict[str, Any] = {}
        self.bus: Optional["MessageBus"] = None

    def settings_loaded(self, settings: Dict[str, Any]) -> None:
        self.settings.update(settings)

    def store_settings(self) -> Dict[str, Any]:
        return dict(self.settings)

    def receive_command(self, sender: str, command: str, params: Dict[str, Any]) -> None:
        pass


class Extension(Plugin):
    """Post-processing extension receiving raw and/or processed streams."""

    #: grab-permission flags (extension.h:88-89): the runtime skips copying
    #: data to extensions that don't want it.
    wants_raw_data: bool = False
    wants_processed_data: bool = False

    def __init__(self) -> None:
        super().__init__()
        self.active = False

    def activate(self) -> None:
        self.active = True

    def deactivate(self) -> None:
        self.active = False

    def raw_data_received(self, buffer: np.ndarray, bit_depth: int,
                          samples_per_line: int, ascans_per_bscan: int,
                          bscans_per_buffer: int, buffers_per_volume: int,
                          current_buffer_nr: int) -> None:
        pass

    def processed_data_received(self, buffer: np.ndarray, bit_depth: int,
                                samples_per_line: int, ascans_per_bscan: int,
                                bscans_per_buffer: int, buffers_per_volume: int,
                                current_buffer_nr: int) -> None:
        pass

    def get_output(self) -> Optional[Dict[str, Any]]:
        """Latest result for generic output hosting (the headless analog of
        ``Extension::getWidget``, extension.h:40-43,75-85: ANY extension
        gets a display surface with zero viewer edits).

        Return None (no output yet) or a dict of any of:

        * ``scalars``: {name: number|str}        -> key/value readout
        * ``series``:  {name: 1-D list}          -> bar/line mini-plot
        * ``table``:   [{col: val, ...}, ...]    -> monospace rows
        * ``image``:   2-D list of 0..1 floats   -> grayscale pane
        * ``text``:    str                       -> preformatted block

        Served at ``/extension.json?name=...`` and rendered generically by
        the live viewer (viz/live.py)."""
        return None


class MessageBus:
    """Named inter-plugin command routing (pluginmessagebus.cpp:28-56)."""

    def __init__(self) -> None:
        self._plugins: Dict[str, Plugin] = {}

    def register(self, plugin: Plugin) -> None:
        self._plugins[plugin.name] = plugin
        plugin.bus = self

    def unregister(self, name: str) -> None:
        p = self._plugins.pop(name, None)
        if p is not None:
            p.bus = None

    def send_command(self, sender: str, target: str, command: str,
                     params: Optional[Dict[str, Any]] = None) -> bool:
        plugin = self._plugins.get(target)
        if plugin is None:
            return False
        plugin.receive_command(sender, command, params or {})
        return True

    def broadcast(self, sender: str, command: str,
                  params: Optional[Dict[str, Any]] = None) -> None:
        # snapshot: a handler may (un)register plugins mid-broadcast
        for name, plugin in list(self._plugins.items()):
            if name != sender:
                plugin.receive_command(sender, command, params or {})


class ExtensionManager:
    """Registry + data-feed fan-out (extensionmanager.cpp:68-81)."""

    def __init__(self, bus: Optional[MessageBus] = None) -> None:
        self.extensions: Dict[str, Extension] = {}
        self.bus = bus or MessageBus()

    def add(self, ext: Extension) -> None:
        self.extensions[ext.name] = ext
        self.bus.register(ext)

    def remove(self, name: str) -> None:
        ext = self.extensions.pop(name, None)
        if ext is not None:
            if ext.active:
                ext.deactivate()
            self.bus.unregister(name)

    def activate(self, name: str) -> None:
        self.extensions[name].activate()

    def deactivate(self, name: str) -> None:
        self.extensions[name].deactivate()

    def _fanout(self, method: str, wants_attr: str, buffer: np.ndarray,
                acq: AcqParams, bit_depth: int, current_buffer_nr: int) -> None:
        for ext in self.extensions.values():
            if ext.active and getattr(ext, wants_attr):
                getattr(ext, method)(
                    buffer, bit_depth, acq.samples_per_line,
                    acq.ascans_per_bscan, acq.bscans_per_buffer,
                    acq.buffers_per_volume, current_buffer_nr)

    def feed_raw(self, buffer: np.ndarray, acq: AcqParams,
                 current_buffer_nr: int) -> None:
        self._fanout("raw_data_received", "wants_raw_data", buffer, acq,
                     acq.bit_depth, current_buffer_nr)

    def feed_processed(self, buffer: np.ndarray, acq: AcqParams,
                       bit_depth: int, current_buffer_nr: int) -> None:
        self._fanout("processed_data_received", "wants_processed_data", buffer,
                     acq, bit_depth, current_buffer_nr)
