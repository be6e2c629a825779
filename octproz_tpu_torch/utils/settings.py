"""INI settings persistence with per-group maps, timestamping and backup.

Capability-equivalent of the reference's ``SettingsFileManager``
(octproz_project/octproz/src/settingsfilemanager.{h,cpp}): one INI file at a
config location (settingsfilemanager.h:36-42), per-plugin/group key-value
maps round-tripped as a unit (settingsfilemanager.h:100-116), a timestamp
record, load/save with a rotating backup copy (octprozapp.cpp:526-583), and
a copy-to-path used as recording metadata (octprozapp.cpp:295-298).

Values are stored as strings in the INI (like QSettings); ``get_group``
returns them as written, and typed helpers parse on read.

A copy of ``octproz_tpu/utils/settings.py``: both packages read and write
the same file at the same default location.
"""

from __future__ import annotations

import configparser
import os
import shutil
import time
from typing import Any, Dict, Optional


def default_settings_path(app_name: str = "octproz_tpu") -> str:
    """~/.config/<app>/settings.ini -- the XDG analog of
    QStandardPaths::ConfigLocation (settingsfilemanager.h:36-42)."""
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(base, app_name, "settings.ini")


class SettingsManager:
    TIMESTAMP_GROUP = "main"
    TIMESTAMP_KEY = "timestamp"

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_settings_path()
        self._parser = configparser.ConfigParser(interpolation=None)
        # preserve key case (QSettings semantics): per-plugin groups hold
        # arbitrary keys ('filePath' must round-trip, not become
        # 'filepath'); the built-in tables are all-lowercase like the
        # reference's sidebar.h macros, so they are unaffected
        self._parser.optionxform = str
        if os.path.exists(self.path):
            self._parser.read(self.path)

    # -- group round-trip (settingsfilemanager.h:100-116) -------------------
    def set_group(self, group: str, values: Dict[str, Any]) -> None:
        """Replace a whole group (the QVariantMap storeSettings analog)."""
        if self._parser.has_section(group):
            self._parser.remove_section(group)
        self._parser.add_section(group)
        for k, v in values.items():
            self._parser.set(group, k, str(v))

    def update_group(self, group: str, values: Dict[str, Any]) -> None:
        if not self._parser.has_section(group):
            self._parser.add_section(group)
        for k, v in values.items():
            self._parser.set(group, k, str(v))

    def get_group(self, group: str) -> Dict[str, str]:
        if not self._parser.has_section(group):
            return {}
        return dict(self._parser.items(group))

    # -- typed getters ------------------------------------------------------
    def get(self, group: str, key: str, default: Any = None) -> Any:
        try:
            return self._parser.get(group, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def get_int(self, group: str, key: str, default: int = 0) -> int:
        v = self.get(group, key)
        return default if v is None else int(float(v))

    def get_float(self, group: str, key: str, default: float = 0.0) -> float:
        v = self.get(group, key)
        return default if v is None else float(v)

    def get_bool(self, group: str, key: str, default: bool = False) -> bool:
        v = self.get(group, key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    # -- persistence with backup (octprozapp.cpp:526-583) -------------------
    def save(self, timestamp: bool = True) -> None:
        if timestamp:
            self.update_group(self.TIMESTAMP_GROUP, {
                self.TIMESTAMP_KEY: time.strftime("%Y-%m-%d %H:%M:%S")})
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.path):
            shutil.copyfile(self.path, self.path + ".backup")
        with open(self.path, "w") as f:
            self._parser.write(f)

    def reload(self) -> None:
        self._parser = configparser.ConfigParser(interpolation=None)
        if os.path.exists(self.path):
            self._parser.read(self.path)

    def copy_to(self, dest_path: str) -> str:
        """Copy the settings file (recording-metadata analog,
        octprozapp.cpp:295-298).  Saves first so the copy is current."""
        self.save()
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        shutil.copyfile(self.path, dest_path)
        return dest_path
