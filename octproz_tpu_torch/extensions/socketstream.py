"""TCP streaming + remote-control server.

A copy of ``octproz_tpu/extensions/socketstream.py`` (standard library and
numpy only).

Capability-equivalent of the reference's Socket Stream Extension (remote
control and data streaming over TCP/IP / WebSocket / IPC,
docs/docs/plugins.md:32-33).  Protocol (newline-delimited JSON control
channel with length-prefixed binary frames):

  client -> server:  one JSON object per line
      {"command": "subscribe", "what": "processed"}   start frame push
      {"command": "unsubscribe"}
      {"command": "ping"}                             -> {"reply": "pong"}
      {"command": <name>, "target": <plugin>, ...}    routed to the message
                                                      bus (remote control)
  server -> client:  {"type": "frame", "nbytes": N, "dtype": ..., "shape":
      [...], "buffer_nr": k}\\n  followed by exactly N raw bytes.
"""

from __future__ import annotations

import json
import queue
import socketserver
import threading
from typing import Dict, Optional

import numpy as np

from ..plugins import Extension, MessageBus


class _ClientHandler(socketserver.StreamRequestHandler):
    def handle(self):
        server: "_StreamServer" = self.server  # type: ignore[assignment]
        self._subscribed = False
        server.register_client(self)
        try:
            for raw_line in self.rfile:
                line = raw_line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line.decode())
                except (ValueError, UnicodeDecodeError):
                    self.send_json({"error": "invalid json"})
                    continue
                if not isinstance(msg, dict):
                    # valid JSON but not an object ("x", [1], 42): an error
                    # reply, not a dropped connection
                    self.send_json({"error": "expected a json object"})
                    continue
                self._dispatch(msg, server)
        except (ConnectionError, OSError):
            pass
        finally:
            server.unregister_client(self)

    # -- outgoing channel: bounded queue + writer thread ---------------------
    # All writes go through a per-client queue drained by a dedicated writer
    # thread, so the ENGINE thread never blocks on a client's TCP buffer: a
    # subscriber that stops reading gets its frames DROPPED (the streaming
    # path already has skip-N decimation semantics; a stalled consumer is
    # the same condition), and the stream keeps running.

    def start_writer(self) -> None:
        self._sendq: "queue.Queue" = queue.Queue(maxsize=4)
        self._writer_dead = False
        self.frames_dropped = 0
        self._writer = threading.Thread(target=self._drain_sendq,
                                        name="socket-stream-writer",
                                        daemon=True)
        self._writer.start()

    def stop_writer(self) -> None:
        try:
            self._sendq.put_nowait(None)
        except queue.Full:
            pass  # writer is stuck mid-write; it dies with the connection

    def _drain_sendq(self) -> None:
        while True:
            item = self._sendq.get()
            if item is None:
                return
            try:
                for chunk in item:
                    self.wfile.write(chunk)
                self.wfile.flush()
            except (ConnectionError, OSError):
                self._writer_dead = True
                return

    def _dispatch(self, msg: Dict, server: "_StreamServer") -> None:
        cmd = msg.get("command")
        if cmd == "subscribe":
            self._subscribed = True
            self.send_json({"reply": "subscribed"})
        elif cmd == "unsubscribe":
            self._subscribed = False
            self.send_json({"reply": "unsubscribed"})
        elif cmd == "ping":
            self.send_json({"reply": "pong"})
        elif cmd is None:
            self.send_json({"error": "missing command"})
        else:
            handled = server.route_command(msg)
            self.send_json({"reply": "ok" if handled else "unknown command"})

    def send_json(self, obj: Dict) -> None:
        """Control replies: small, must not be dropped — block briefly."""
        if self._writer_dead:
            raise ConnectionError("writer thread dead")
        try:
            self._sendq.put(((json.dumps(obj) + "\n").encode(),),
                            timeout=2.0)
        except queue.Full:
            raise ConnectionError("client not draining control replies")

    def send_frame(self, array: np.ndarray, buffer_nr: int) -> None:
        """Data frames: NEVER block the engine thread — drop when the
        client's queue is full (stalled consumer)."""
        if not self._subscribed:
            return
        if self._writer_dead:
            raise ConnectionError("writer thread dead")
        if self._sendq.full():
            # advisory fast-path: don't pay the megabyte serialization for
            # a frame that will be dropped anyway (put_nowait below still
            # guards the race)
            self.frames_dropped += 1
            return
        data = np.ascontiguousarray(array)
        header = json.dumps({
            "type": "frame", "nbytes": data.nbytes, "dtype": str(data.dtype),
            "shape": list(data.shape), "buffer_nr": buffer_nr}) + "\n"
        try:
            self._sendq.put_nowait((header.encode(), data.tobytes()))
        except queue.Full:
            self.frames_dropped += 1


class _StreamServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, bus: Optional[MessageBus]):
        super().__init__(addr, _ClientHandler)
        self._clients: list = []
        self._clients_lock = threading.Lock()
        self._bus = bus
        self.frames_dropped_closed = 0  # from disconnected clients

    def register_client(self, client) -> None:
        client.start_writer()
        with self._clients_lock:
            self._clients.append(client)

    def unregister_client(self, client) -> None:
        client.stop_writer()
        with self._clients_lock:
            if client in self._clients:
                self._clients.remove(client)
                # keep the aggregate drop counter monotonic
                self.frames_dropped_closed += getattr(client,
                                                      "frames_dropped", 0)

    def route_command(self, msg: Dict) -> bool:
        """Remote control: forward to the plugin message bus
        (pluginmessagebus.cpp:28-56 analog)."""
        if self._bus is None:
            return False
        target = msg.get("target", "")
        params = {k: v for k, v in msg.items() if k not in ("command", "target")}
        if target:
            return self._bus.send_command("socket-stream", target,
                                          msg["command"], params)
        self._bus.broadcast("socket-stream", msg["command"], params)
        return True

    def push_frame(self, array: np.ndarray, buffer_nr: int) -> int:
        with self._clients_lock:
            clients = list(self._clients)
        sent = 0
        for c in clients:
            try:
                c.send_frame(array, buffer_nr)
                sent += 1
            except (ConnectionError, OSError):
                self.unregister_client(c)
        return sent


class SocketStreamServer(Extension):
    """Extension that serves the processed stream over TCP and routes remote
    commands into the message bus.  Start with :meth:`start`; port 0 picks a
    free port (see ``.port``)."""

    name = "socket-stream"
    wants_processed_data = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 bus: Optional[MessageBus] = None):
        super().__init__()
        self._server = _StreamServer((host, port), bus or MessageBus())
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="octproz-socket-stream")
        self._thread.start()
        self.activate()

    def stop(self) -> None:
        self.deactivate()
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def processed_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self._server.push_frame(np.asarray(buffer), nr)

    @property
    def frames_dropped(self) -> int:
        """Total frames dropped because client send queues were full
        (stalled consumers) — monotonic across disconnects."""
        with self._server._clients_lock:
            live = sum(getattr(c, "frames_dropped", 0)
                       for c in self._server._clients)
            return self._server.frames_dropped_closed + live


def read_frame(sock_file) -> Optional[Dict]:
    """Client-side helper: read one server message; for frames, attaches the
    decoded array under ``"data"``."""
    line = sock_file.readline()
    if not line:
        return None
    msg = json.loads(line.decode())
    if msg.get("type") == "frame":
        payload = sock_file.read(msg["nbytes"])
        msg["data"] = np.frombuffer(payload, dtype=msg["dtype"]).reshape(msg["shape"])
    return msg
