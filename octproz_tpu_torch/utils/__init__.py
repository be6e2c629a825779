"""Host-side utilities: the message console, the device report, profiling,
settings, device-memory preflight and fidelity metrics."""

from .console import MessageConsole  # noqa: F401
from .deviceinfo import device_report  # noqa: F401
