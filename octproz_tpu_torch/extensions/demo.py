"""Demo extension: the developer template.

A copy of ``octproz_tpu/extensions/demo.py`` (numpy only).

Capability-equivalent of the reference's DemoExtension
(octproz_plugins/octproz-demo-extension/src/demoextension.cpp:88-115): shows
the buffer access pattern, per-bit-depth casting, and the re-entrancy guard
that keeps slow per-frame work from stalling the stream.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..plugins import Extension


class DemoExtension(Extension):
    """Computes the average intensity of every Nth processed frame.

    Copy this file to start your own extension; the three things it
    demonstrates are the things every extension needs:

    1. declare what data you want (``wants_processed_data`` /
       ``wants_raw_data``) -- inactive or indifferent extensions cost nothing;
    2. normalize by bit depth before interpreting values;
    3. guard against re-entry if your processing can be slower than the frame
       rate (the runtime will not queue for you -- same contract as the
       reference, demoextension.cpp:88-97).
    """

    name = "demo-extension"
    wants_processed_data = True

    def __init__(self, frame_decimation: int = 1):
        super().__init__()
        self.frame_decimation = max(1, frame_decimation)
        self.average_intensity: Optional[float] = None
        self.frames_seen = 0
        self._busy = threading.Lock()

    def processed_data_received(self, buffer, bit_depth, samples_per_line,
                                ascans_per_bscan, bscans_per_buffer,
                                buffers_per_volume, current_buffer_nr):
        self.frames_seen += 1
        if (self.frames_seen - 1) % self.frame_decimation:
            return
        if not self._busy.acquire(blocking=False):
            return  # re-entrancy guard: still working on the previous frame
        try:
            # quantized streams normalize by the quantizer's CODE max
            # (ops/quantize.dequantize) — not 2**bit_depth-1, which is
            # wrong for bit depths off the quantizer ladder
            from ..ops.quantize import dequantize

            data = np.asarray(dequantize(buffer, bit_depth), np.float64)
            self.average_intensity = float(data.mean())
        finally:
            self._busy.release()

    def receive_command(self, sender, command, params):
        if command == "set_decimation":
            self.frame_decimation = max(1, int(params.get("value", 1)))
