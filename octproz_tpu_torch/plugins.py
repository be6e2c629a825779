"""Extension (plugin) hook API and inter-plugin message bus.

A copy of ``octproz_tpu/plugins.py`` (numpy only), the reference DevKit's
plugin surface and its loading:

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
* :class:`PluginContext`, :func:`load_plugin`, :func:`load_plugins` and
  :func:`discover_entry_point_plugins` mirror the reference's plugin
  discovery pass (octprozapp.cpp:99-174, QPluginLoader): a plugin is a
  module-path spec or an installed entry point of the group
  ``octproz_tpu_torch.plugins`` that registers extensions and acquisition
  systems (``io.systems.SystemRegistry``) into the context.

The streaming runtime invokes the hooks synchronously on its host loop with
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

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


class PluginContext:
    """What a loaded plugin may register into — the app-side registries.

    The analog of what ``OCTproZApp::loadSystemsAndExtensions`` hands each
    QPluginLoader root component (octprozapp.cpp:139-169): the extension
    manager, the system manager, and the settings store.  Third-party
    plugin factories receive this and call :meth:`register_extension` /
    :meth:`register_system`; returning an Extension from the factory is an
    accepted shorthand for registering it.
    """

    def __init__(self, extensions: Optional["ExtensionManager"] = None,
                 systems=None, settings: Optional[Dict[str, Any]] = None):
        self.extensions = extensions if extensions is not None \
            else ExtensionManager()
        self.systems = systems  # io.systems.SystemRegistry or None
        self.settings = settings or {}
        #: (kind, name) pairs in load order — the discovery report the app
        #: logs (octprozapp.cpp:156-169 info messages)
        self.loaded: List[tuple] = []

    def register_extension(self, ext: "Extension") -> None:
        if isinstance(ext, type):
            ext = ext()
        if not isinstance(ext, Extension):
            raise TypeError(f"not an Extension: {ext!r}")
        self.extensions.add(ext)
        # per-plugin settings group round-trip (plugin.h:43-45)
        group = self.settings.get(f"extension:{ext.name}")
        if group:
            ext.settings_loaded(group)
        self.loaded.append(("extension", ext.name))

    def register_system(self, name: str, factory) -> None:
        """Register ``factory(settings: dict) -> AcquisitionSource`` under
        ``name`` (SystemRegistry factory contract)."""
        if self.systems is None:
            raise RuntimeError(
                "this session has no acquisition-system registry; system "
                "plugins need one (pass systems= to PluginContext)")
        self.systems.register(name, factory)
        self.loaded.append(("system", name))


def _register_target(target, ctx: PluginContext, spec: str) -> None:
    """Dispatch a resolved plugin object — the ``qobject_cast`` analog
    (octprozapp.cpp:156-169): Extension subclass/instance registers
    directly; any other callable is a plugin factory invoked with the
    context (it may register several things and/or return an Extension)."""
    if isinstance(target, type) and issubclass(target, Extension):
        ctx.register_extension(target())
        return
    if isinstance(target, Extension):
        ctx.register_extension(target)
        return
    if callable(target):
        result = target(ctx)
        if result is not None:
            if callable(result) and not (
                    isinstance(result, Extension)
                    or (isinstance(result, type)
                        and issubclass(result, Extension))):
                raise TypeError(
                    f"plugin factory {spec!r} returned another callable; "
                    "factories must register via the context or return an "
                    "Extension")
            _register_target(result, ctx, spec)
        return
    raise TypeError(
        f"plugin target {spec!r} is {type(target).__name__}; expected an "
        "Extension subclass/instance or a factory callable")


def load_plugin(spec: str, ctx: PluginContext) -> None:
    """Load one plugin from a module-path spec: ``pkg.mod:attr`` or
    ``pkg.mod`` (which uses the module's ``octproz_plugin`` attribute).

    The runtime-discovery analog of the reference's QPluginLoader pass over
    the plugins directory (octprozapp.cpp:99-174): third parties add
    acquisition systems and extensions WITHOUT editing this framework."""
    import importlib

    mod_name, _, attr = spec.partition(":")
    mod = importlib.import_module(mod_name)
    if not attr:
        attr = "octproz_plugin"
        if not hasattr(mod, attr):
            raise ValueError(
                f"plugin module {mod_name!r} defines no 'octproz_plugin' "
                "entry; name the factory explicitly as 'pkg.mod:attr'")
    _register_target(getattr(mod, attr), ctx, spec)


#: Entry-point group third-party distributions advertise the port's plugins
#: under (a group of its own: a plugin of the JAX package's group subclasses
#: that package's Extension and would import JAX):
#:   [project.entry-points."octproz_tpu_torch.plugins"]
#:   my_plugin = "my_pkg.plugin:factory"
ENTRY_POINT_GROUP = "octproz_tpu_torch.plugins"


def discover_entry_point_plugins(ctx: PluginContext,
                                 group: str = ENTRY_POINT_GROUP) -> List[str]:
    """Load every installed entry-point plugin; returns the names loaded.

    A distribution that fails to load (import error, broken factory) is
    reported on stderr and SKIPPED — one bad installed package must not
    take every session down, matching the reference's per-plugin
    load-failure tolerance (octprozapp.cpp:170-173).  Explicit ``--plugins``
    specs stay loud (load_plugin raises): the user asked for that one.
    """
    import sys
    from importlib import metadata

    eps = metadata.entry_points()
    sel = (eps.select(group=group) if hasattr(eps, "select")
           else eps.get(group, []))
    names = []
    for ep in sel:
        try:
            _register_target(ep.load(), ctx, f"{group}:{ep.name}")
        except Exception as e:
            print(f"plugin entry point '{ep.name}' failed to load and was "
                  f"skipped: {type(e).__name__}: {e}", file=sys.stderr)
            continue
        names.append(ep.name)
    return names


def load_plugins(specs, ctx: PluginContext,
                 entry_points: bool = True) -> PluginContext:
    """Load entry-point plugins then each explicit spec, in order."""
    if entry_points:
        discover_entry_point_plugins(ctx)
    for spec in specs or ():
        load_plugin(spec, ctx)
    return ctx


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
