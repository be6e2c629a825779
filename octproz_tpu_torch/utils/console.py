"""Timestamped info/error message log with subscribers.

Capability-equivalent of the reference's ``MessageConsole`` dock
(octproz_project/octproz/src/messageconsole.{h,cpp}) -- the sink of every
``info(QString)``/``error(QString)`` signal chain (octprozapp.cpp:49-54).
Headless-first: messages go to a bounded in-memory log, optional stdout
mirror, and any number of subscriber callbacks (the signal analog).

A copy of ``octproz_tpu/utils/console.py``: pure Python, so the two
packages log the same messages in the same format.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, List, NamedTuple


class Message(NamedTuple):
    timestamp: str
    level: str  # "info" | "error"
    text: str

    def format(self) -> str:
        tag = "ERROR: " if self.level == "error" else ""
        return f"[{self.timestamp}] {tag}{self.text}"


class MessageConsole:
    def __init__(self, max_messages: int = 1000, echo: bool = False):
        self.messages: Deque[Message] = collections.deque(maxlen=max_messages)
        self.echo = echo
        self._subscribers: List[Callable[[Message], None]] = []

    def subscribe(self, callback: Callable[[Message], None]) -> None:
        self._subscribers.append(callback)

    def _emit(self, level: str, text: str) -> None:
        msg = Message(time.strftime("%H:%M:%S"), level, str(text))
        self.messages.append(msg)
        if self.echo:
            print(msg.format(), flush=True)
        for cb in list(self._subscribers):
            try:
                cb(msg)
            except Exception as e:
                # a broken log subscriber must never kill the stream that is
                # merely logging (decoupled signal/slot semantics)
                print(f"[console] subscriber failed: {e}", flush=True)

    def info(self, text: str) -> None:
        self._emit("info", text)

    def error(self, text: str) -> None:
        self._emit("error", text)

    def dump(self) -> str:
        return "\n".join(m.format() for m in self.messages)
