"""Hardware bridge: the acquisition-side API for real digitizer producers.

Counterpart of ``octproz_tpu/io/hwbridge.py``: handing the DevKit's
``AcquisitionBuffer`` to an acquisition-system plugin
(octproz_devkit/src/acquisitionbuffer.h:53-58 + acquisitionsystem.h:65).  A
producer (frame-grabber callback, C thread, or another process via the raw
slot pointers) fills 128-byte-aligned ring slots and marks them ready; the
streaming runtime consumes them in FIFO order with the same back-pressure
handshake as the reference's ``bufferReadyArray`` spin-wait.

The ring is the port's native C++ one (``native.NativeRingBuffer``): slot
addresses are stable and can be passed to DMA-capable acquisition APIs.
``buffers()`` hands out a copy of each slot, which the engine's upload
thread then stages into its pinned ring.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

import numpy as np

from .. import native
from ..params import AcqParams
from .source import _np_dtype


class HardwareRingSource:
    """AcquisitionSource backed by the native aligned ring buffer.

    Producer side (your acquisition callback):

        slot = src.acquire_write()           # -1 while the consumer is behind
        if slot >= 0:
            src.view(slot)[:] = frame        # or DMA into src.slot_address(slot)
            src.commit_write(slot)

    Consumer side: hand the object to StreamingEngine as its source; its
    ``buffers()`` iterator yields ready slots in FIFO order.  Call
    :meth:`finish` to end the stream after the current backlog drains.
    """

    def __init__(self, acq: AcqParams, n_slots: int = 4,
                 poll_interval_s: float = 0.0005,
                 timeout_s: Optional[float] = 10.0):
        self.acq = acq
        self.ring = native.NativeRingBuffer(n_slots, acq.buffer_shape,
                                            _np_dtype(acq.bit_depth))
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s
        self._final_count: Optional[int] = None
        # the consumer's ring calls and close() exclude each other: a
        # consumer thread still polling when the owner closes must not
        # touch the freed ring, it ends its stream instead
        self._lock = threading.Lock()
        self._closed = False

    # -- producer API -------------------------------------------------------
    def acquire_write(self) -> int:
        return self.ring.acquire_write()

    def commit_write(self, slot: int) -> None:
        self.ring.commit_write(slot)

    def view(self, slot: int) -> np.ndarray:
        return self.ring.view(slot)

    def slot_address(self, slot: int) -> int:
        """Raw memory address of a slot (for DMA registration)."""
        return self.ring.view(slot).ctypes.data

    def write_blocking(self, frame: np.ndarray,
                       timeout_s: float = 10.0) -> None:
        """Convenience producer: spin until a slot frees (the reference
        producer's spin-wait, virtualoctsystem.cpp:196-203)."""
        deadline = time.monotonic() + timeout_s
        while (slot := self.ring.acquire_write()) < 0:
            if time.monotonic() > deadline:
                raise TimeoutError("ring full: consumer not draining")
            time.sleep(self.poll_interval_s)
        self.ring.view(slot)[:] = frame
        self.ring.commit_write(slot)

    def finish(self) -> None:
        """Signal end-of-stream by publishing the final produced count.

        MUST be called on the producer thread after its last
        :meth:`commit_write` (the producer's own ``finally`` is the natural
        place): the consumer then drains until ``consumed == produced`` --
        a count contract.  A bare ``finished`` flag with an empty poll has a
        lost-wakeup race: the consumer polls an empty ring, the producer
        commits the final slot AND sets the flag, the consumer then sees the
        flag and returns with a committed slot unread.
        """
        self._final_count = self.ring.produced()

    # -- consumer API (AcquisitionSource protocol) --------------------------
    def buffers(self) -> Iterator[np.ndarray]:
        idle_since = None
        while True:
            with self._lock:
                if self._closed:
                    return
                final = self._final_count
                if final is not None and self.ring.consumed() >= final:
                    return
                slot = self.ring.acquire_read()
                if slot >= 0:
                    # hand out a copy: the slot is recycled as soon as we release it
                    data = self.ring.view(slot).copy()
                    self.ring.release_read(slot)
            if slot < 0:
                # the ring was polled AFTER reading the final count, so
                # "empty + count reached" can never lose a commit; with a
                # published count, committed slots are already visible and
                # the next poll picks them up
                now = time.monotonic()
                idle_since = idle_since or now
                if self.timeout_s is not None and now - idle_since > self.timeout_s:
                    raise TimeoutError(
                        f"no acquisition data for {self.timeout_s:.0f} s")
                time.sleep(self.poll_interval_s)
                continue
            idle_since = None
            yield data

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self.ring.close()
