"""Volume assembly: accumulate per-buffer processed blocks into whole
volumes.  A copy of ``octproz_tpu/io/volume.py`` (numpy only).

Capability-equivalent of the reference's persistent device volume
accumulator ``d_processedBuffer`` (octproz_project/octproz/src/cuda_code.cu:
1118,1530-1535: a float buffer holding the half-resolution samples of ALL
buffers of a volume, written block-wise at offset ``(samples/2) *
bufferNumberInVolume``), which the display and volume-view kernels slice.
Host-side here: the streaming runtime fetches decimated blocks and the
assembler stitches them into (total_bscans, ascans, depth) volumes, invoking
a callback whenever a volume completes.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..params import AcqParams


class VolumeAssembler:
    """Stitch per-buffer processed blocks into full volumes.

    Feed blocks via :meth:`add`; when all ``buffers_per_volume`` slots of a
    volume have arrived, ``on_volume(volume, volume_index)`` fires and the
    accumulator recycles (the next volume reuses the storage, like the
    reference overwriting d_processedBuffer in place).

    Out-of-order and decimated feeds are tolerated: a block for slot k of a
    *new* volume finalizes nothing (incomplete volumes are dropped when the
    next wrap begins, mirroring the reference's overwrite semantics).
    """

    def __init__(self, acq: AcqParams, dtype=np.float32,
                 on_volume: Optional[Callable[[np.ndarray, int], None]] = None):
        self.acq = acq
        self.dtype = np.dtype(dtype)
        self.on_volume = on_volume
        n_total_bscans = acq.bscans_per_buffer * max(acq.buffers_per_volume, 1)
        self._volume = np.zeros(
            (n_total_bscans, acq.ascans_per_bscan, acq.output_ascan_length),
            self.dtype)
        self._filled = np.zeros(max(acq.buffers_per_volume, 1), bool)
        self.volume_index = 0
        self.volumes_completed = 0

    @property
    def volume(self) -> np.ndarray:
        """The (possibly partial) current volume."""
        return self._volume

    def add(self, processed_block: np.ndarray, buffer_nr_in_volume: int) -> Optional[np.ndarray]:
        """Insert one processed block; returns the completed volume when this
        block finishes it, else None."""
        bpv = self._filled.size
        k = buffer_nr_in_volume % bpv
        block = np.asarray(processed_block)
        if self._filled[k]:
            # wrap: a slot is being overwritten -> a new volume has begun
            self._filled[:] = False
            self.volume_index += 1
        b0 = k * self.acq.bscans_per_buffer
        self._volume[b0:b0 + self.acq.bscans_per_buffer] = block.astype(
            self.dtype, copy=False)
        self._filled[k] = True
        if self._filled.all():
            self.volumes_completed += 1
            if self.on_volume is not None:
                self.on_volume(self._volume, self.volume_index)
            out = self._volume
            self._filled[:] = False
            self.volume_index += 1
            return out
        return None
