"""Acquisition-system registry: named sources with activation lifecycle and
settings round-trip.

A copy of ``octproz_tpu/io/systems.py`` on the port's settings store.
Capability-equivalent of the reference's ``SystemManager`` (octproz_project/
octproz/src/systemmanager.{h,cpp}: registry of loaded AcquisitionSystem* by
name) plus the activate/deactivate flow of ``OCTproZApp::setSystem``
(octprozapp.cpp:334-366) and the per-plugin settings groups
(octprozapp.cpp:404-406).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .source import AcquisitionSource
from ..utils.settings import SettingsManager


class SystemRegistry:
    """Named acquisition-system factories.

    A *factory* is ``fn(settings: dict) -> AcquisitionSource`` so systems can
    be (re)instantiated with fresh settings each activation, like the
    reference re-running ``AcquisitionSystem::init``.
    """

    def __init__(self, settings: Optional[SettingsManager] = None):
        self._factories: Dict[str, Callable[[dict], AcquisitionSource]] = {}
        self._settings = settings
        self.active_name: Optional[str] = None
        self.active_source: Optional[AcquisitionSource] = None

    def register(self, name: str,
                 factory: Callable[[dict], AcquisitionSource]) -> None:
        self._factories[name] = factory

    @property
    def names(self):
        return sorted(self._factories)

    def activate(self, name: str,
                 overrides: Optional[dict] = None) -> AcquisitionSource:
        """Instantiate the named system with its stored settings (+overrides).

        Deactivates any previously active system first (setSystem semantics,
        octprozapp.cpp:334-347)."""
        if name not in self._factories:
            raise KeyError(f"unknown acquisition system '{name}' "
                           f"(registered: {', '.join(self.names) or 'none'})")
        self.deactivate()
        stored = (self._settings.get_group(f"system:{name}")
                  if self._settings else {})
        if overrides:
            stored = {**stored, **overrides}
        source = self._factories[name](stored)
        self.active_name = name
        self.active_source = source
        return source

    def deactivate(self) -> None:
        src = self.active_source
        try:
            if src is not None and hasattr(src, "close"):
                src.close()
        finally:
            # clear even when close() raises: the registry must never stay
            # pinned to a dead source (each activate() deactivates first)
            self.active_name = None
            self.active_source = None

    def store_settings(self, name: str, values: dict) -> None:
        """Persist a system's settings group (storeSettings analog)."""
        if self._settings is None:
            raise RuntimeError("registry created without a SettingsManager")
        self._settings.set_group(f"system:{name}", values)
        self._settings.save()
