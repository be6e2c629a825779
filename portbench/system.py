"""The system under test as the cells of ``FdOctModel`` build it: the
cell's raw buffers made from the seed, the model of its configuration, and
the warm-up of the shapes the window will use.  A traffic kind
(``kinds/<kind>.py``) builds its set-up from these pieces, or from its own
where it drives another entry of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from . import loadgen
from .interferograms import make_volumes


@dataclasses.dataclass
class Setup:
    """What a kind's ``setup`` hands to its ``drive`` and to the harness.

    ``model`` is what the window drives; ``ring`` the raw buffers it hands
    over, as made from the seed; ``first_raw`` and ``first_out`` the
    set-up's first buffer, which determines the FPN state, and its output,
    judged beside the window's; ``variant(**changes)`` a model of the cell
    with ``ProcConfig`` changes, for a per-layer timing on the same ring."""

    model: object
    ring: List
    device: object
    first_raw: object
    first_out: object
    variant: Callable

    def steady_ms(self, count: int = 48, **changes) -> float:
        """CUDA-event ms per buffer of ``process_buffer`` over the ring,
        dispatched ahead, after a warm-up: of the cell's model, or of its
        ``variant(**changes)``."""
        model = self.variant(**changes) if changes else self.model
        for i in range(4):
            model.process_buffer(self.ring[i % len(self.ring)])
        start, stop = loadgen.new_event(self.device), loadgen.new_event(self.device)
        loadgen.sync(self.device)
        start.record()
        for i in range(count):
            model.process_buffer(self.ring[i % len(self.ring)])
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / count


def warm(drive, cell, s: Setup, seed: int) -> None:
    """``traffic["warmup_s"]`` of a kind's own window (its ``drive``),
    holding as many outputs as the window's sample will: the caching
    allocator takes every device segment the window needs now, and none
    inside the window (each is a cudaMalloc, which stalls the host for up
    to a hundred ms)."""
    if cell.traffic.get("warmup_s"):
        drive(cell, s, cell.traffic["warmup_s"], loadgen.Sample(cell.traffic["compare"], seed), [])
        loadgen.sync(s.device)


def fdoct(cell, seed: int, device, pinned: bool, changes: Optional[dict] = None,
          wrap=None, log=None) -> Setup:
    """The cell's ``traffic["volumes"]`` raw buffers from the seed, on the
    device, or in pinned host memory where ``pinned`` (what a frame
    grabber's DMA leaves); ``FdOctModel`` of the cell's configuration with
    ``changes`` (the control's lower precision); ``wrap(model)`` may
    replace its entry (the tests' faults).  Warm-up: the FPN buffer, then
    ``traffic["warmup"]`` steady buffers (a kind then runs its own schedule
    for a while: :func:`warm`)."""
    import torch

    from octproz_tpu_torch.models.fdoct import FdOctModel

    acq, cfg, traffic = cell.acq(), cell.proc(**(changes or {})), cell.traffic
    marks = [time.perf_counter()]
    volumes = make_volumes(acq, traffic["volumes"], seed, device,
                           shift=4 if cfg.bitshift else 0, signal=cell.signal)
    if pinned:
        pin = device.type == "cuda"
        ring = [torch.empty(acq.buffer_shape, dtype=volumes.dtype, pin_memory=pin).copy_(v)
                for v in volumes]
        del volumes
    else:
        ring = list(volumes)
    loadgen.sync(device)
    marks.append(time.perf_counter())

    def variant(**more):
        return FdOctModel(acq, cell.proc(**(changes or {}), **more), **cell.curve_kwargs(),
                          device=device)

    model = variant()
    if wrap is not None:
        wrap(model)
    marks.append(time.perf_counter())
    first_out = model.process_buffer(ring[0])
    for i in range(traffic["warmup"]):
        model.process_buffer(ring[(i + 1) % len(ring)])
    loadgen.sync(device)
    marks.append(time.perf_counter())
    if log:
        log("[setup] s: inputs {}, model {}, warm-up (kernel build included) {}".format(
            *(b - a for a, b in zip(marks, marks[1:]))))
    return Setup(model=model, ring=ring, device=device, first_raw=ring[0],
                 first_out=first_out, variant=variant)
