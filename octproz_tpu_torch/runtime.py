"""Streaming runtime: the host loop that drives acquisition -> device ->
subscribers at line rate.

Counterpart of ``octproz_tpu/runtime.py``: the reference's ``Processing``
controller (octproz_project/octproz/src/processing.cpp:136-229 hot loop),
its GPU->host streaming ring (cuda_code.cu:1357-1386, processing.cpp:
316-365) and the ``Gpu2HostNotifier`` callback bridge
(src/gpu2hostnotifier.cpp:75-96), on CUDA streams:

* An acquisition thread (:class:`_Prefetcher`) keeps a bounded queue of
  raw host buffers ahead of the device (the acquisition double buffer,
  acquisitionbuffer.h:53-58).
* An upload thread (:class:`_DeviceFeeder`) copies each buffer into a small
  ring of preallocated pinned host buffers and uploads it on its own CUDA
  stream; the run loop's stream waits on the upload's event before the
  step, so the H2D of buffer i+1 overlaps the compute of buffer i (the
  reference's per-stream ``cudaMemcpyAsync`` feeding the next kernel batch,
  cuda_code.cu:1396-1406).  On the packed-12 wire the unpack runs on the
  upload stream too.
* Device-to-host fetches (the float32 recorder stream and the quantized
  stream) start right after the step, into pinned host memory, on a stream
  of their own.  Every in-flight step carries one CUDA event, and at most
  ``max_in_flight`` steps are outstanding: the drain synchronises the
  oldest event before it hands that buffer to the host side (the
  reference's blocking event, cuda_code.cu:1416-1420).
* GPU->host streaming decimation: every ``streaming_skip + 1``-th processed
  buffer is quantized on the device (ops.quantize ~ floatToOutput,
  cuda_code.cu:943-967) and fetched (``streamingBuffersToSkip``,
  octalgorithmparameters.h:189-192).
* Throughput metrics over 5 s windows: volumes/s, buffers/s, B-scans/s,
  A-scans/s, MB/s -- the numbers of the reference's info box
  (processing.cpp:193-207).

On a CPU model the same loop runs without streams or events: every
operation is synchronous there.  Every queue wait has a timeout, so a
stop request ends the loop even while a thread is wedged.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .io.recorder import Recorder, RecordingParams, RecordingScheduler, write_meta
from .io.source import AcquisitionSource
from .models.fdoct import FdOctModel
from .ops import postprocess
from .ops import quantize as quantize_mod
from .ops.convert import unpack_uint12_packed
from .plugins import ExtensionManager

_POLL_S = 0.1  # every queue wait gives up after this and checks for a stop


@dataclasses.dataclass
class ThroughputStats:
    """One 5-second metrics window (processing.cpp:198-204).

    ``mb_per_s``/``buffer_mb`` are CONTAINER bytes (uint16 samples -- the
    reference's numbers); ``wire_mb_per_s``/``wire_mb`` are the bytes that
    crossed the host->device link, 25 % fewer on the packed-12 wire."""

    buffers_per_s: float = 0.0
    bscans_per_s: float = 0.0
    ascans_per_s: float = 0.0
    volumes_per_s: float = 0.0
    mb_per_s: float = 0.0
    buffer_mb: float = 0.0
    wire_mb_per_s: float = 0.0
    wire_mb: float = 0.0
    buffers_processed: int = 0

    def info_line(self) -> str:
        wire = (f" ({self.wire_mb_per_s:.0f} MB/s wire)"
                if self.wire_mb != self.buffer_mb else "")
        return (f"{self.volumes_per_s:.1f} volumes/s, "
                f"{self.buffers_per_s:.0f} buffers/s ({self.buffer_mb:.1f} MB), "
                f"{self.bscans_per_s:.0f} B-scans/s, "
                f"{self.ascans_per_s / 1e3:.0f} kHz A-scans, "
                f"{self.mb_per_s:.0f} MB/s{wire}")


class ThroughputMeter:
    """Windowed throughput counter (reference: 5 s info-box updates).

    ``wire_bytes_per_buffer``: bytes per buffer on the host->device link
    (default: the container size)."""

    def __init__(self, acq, window_s: float = 5.0,
                 wire_bytes_per_buffer: Optional[int] = None):
        self._acq = acq
        self._window_s = window_s
        self._wire_bytes = (acq.bytes_per_buffer if wire_bytes_per_buffer
                            is None else wire_bytes_per_buffer)
        self._count = 0
        self._t0: Optional[float] = None
        self.total_buffers = 0
        self.last: Optional[ThroughputStats] = None

    def tick(self, now: Optional[float] = None) -> Optional[ThroughputStats]:
        """Count one processed buffer; returns stats when a window closes."""
        now = time.perf_counter() if now is None else now
        if self._t0 is None:
            self._t0 = now
        self._count += 1
        self.total_buffers += 1
        dt = now - self._t0
        if dt < self._window_s:
            return None
        acq = self._acq
        bps = self._count / dt
        buffer_mb = acq.bytes_per_buffer / 1e6
        wire_mb = self._wire_bytes / 1e6
        stats = ThroughputStats(
            buffers_per_s=bps,
            bscans_per_s=bps * acq.bscans_per_buffer,
            ascans_per_s=bps * acq.ascans_per_buffer,
            volumes_per_s=bps / max(acq.buffers_per_volume, 1),
            mb_per_s=bps * buffer_mb,
            buffer_mb=buffer_mb,
            wire_mb_per_s=bps * wire_mb,
            wire_mb=wire_mb,
            buffers_processed=self.total_buffers,
        )
        self._count = 0
        self._t0 = now
        self.last = stats
        return stats


class _Stage:
    """A thread that fills a bounded queue, with end of stream and errors
    passed to the consumer in order: the thread's error (if any) is raised
    by :meth:`get` after every item queued before it."""

    _SENTINEL = object()

    def __init__(self, depth: int, name: str):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._main, daemon=True, name=name)
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        self._thread.start()

    def _items(self):
        raise NotImplementedError

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _main(self) -> None:
        try:
            for item in self._items():
                if self._stop.is_set():
                    break
                self._put(item)
        except BaseException as e:  # propagate into the consumer
            self.error = e
        finally:
            self._put(self._SENTINEL)

    def get(self, stop: Optional[threading.Event] = None):
        """The next item, or None at end of stream -- signalled ONLY by the
        sentinel or the thread's death, never by a transiently empty queue
        -- or when ``stop`` is set (the producer may be wedged)."""
        while True:
            if stop is not None and stop.is_set():
                return None
            try:
                item = self._queue.get(timeout=_POLL_S)
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    if self.error is not None:
                        raise self.error
                    return None
                continue
            if item is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                return None
            return item

    def stop(self) -> None:
        self._stop.set()
        try:  # drain so a blocked producer unblocks
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class _Prefetcher(_Stage):
    """Acquisition thread: a bounded queue of raw host buffers ahead of the
    device step (virtualoctsystem.cpp:196-223).  The bounded queue is the
    back-pressure handshake: when processing falls behind, the producer
    blocks like the reference's spin-wait on ``bufferReadyArray``."""

    def __init__(self, source: AcquisitionSource, depth: int = 2):
        super().__init__(depth, "octproz-acquisition")
        self._source = source

    def _items(self):
        return self._source.buffers()


class _DeviceFeeder(_Stage):
    """Upload thread: (host_raw, device_raw, event) for each buffer of the
    prefetcher, uploaded ahead of the step.

    On a CUDA model each buffer is copied into the next slot of a ring of
    ``ring`` preallocated pinned host buffers, then ``model.put_buffer`` (or
    ``put_packed_buffer``, which also unpacks) runs on this thread's own
    stream, and an event recorded after it marks the upload done.  A slot
    is refilled only after the event of its previous upload completed.  The
    consumer makes its stream wait on the event and marks the device tensor
    as used on its stream (``record_stream``), so the allocator does not
    hand the memory to the next upload while the step still reads it.  On
    a CPU model the upload is the plain ``put`` and the event is None."""

    def __init__(self, prefetcher: _Prefetcher, model: FdOctModel,
                 depth: int = 2, wire_format: str = "uint16", ring: int = 2):
        super().__init__(depth, "octproz-upload")
        self._prefetcher = prefetcher
        self._model = model
        self._put_dev = (model.put_packed_buffer if wire_format == "packed12"
                         else model.put_buffer)
        self._cuda = model.device.type == "cuda"
        self._ring: List[Optional[torch.Tensor]] = [None] * max(2, ring)
        self._done: List[Optional[torch.cuda.Event]] = [None] * len(self._ring)

    def _items(self):
        stream = torch.cuda.Stream(self._model.device) if self._cuda else None
        k = 0
        while not self._stop.is_set():
            raw = self._prefetcher.get(stop=self._stop)
            if raw is None:
                return
            if not self._cuda:
                yield raw, self._put_dev(raw), None
                continue
            slot = k % len(self._ring)
            k += 1
            yield raw, *self._upload(raw, slot, stream)

    def _upload(self, raw, slot: int, stream):
        host = torch.from_numpy(np.ascontiguousarray(raw))
        pinned = self._ring[slot]
        if self._done[slot] is not None:
            self._done[slot].synchronize()  # the slot's last upload is done
        if pinned is None or pinned.shape != host.shape or pinned.dtype != host.dtype:
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            self._ring[slot] = pinned
        pinned.copy_(host)
        with torch.cuda.stream(stream):
            dev = self._put_dev(pinned)
            done = torch.cuda.Event()
            done.record(stream)
        self._done[slot] = done
        return dev, done


class StreamingEngine:
    """The acquisition->processing->subscribers loop.

    Composition (octprozapp.cpp:25-59 object graph):
      source     -> raw feed   -> raw recorder + extensions (raw)
                 -> device step (FdOctModel)
                 -> decimated quantized host fetch -> processed recorder,
                    extensions (processed), on_processed callbacks
    """

    def __init__(
        self,
        model: FdOctModel,
        source: AcquisitionSource,
        extensions: Optional[ExtensionManager] = None,
        stream_to_host: bool = False,
        streaming_skip: int = 0,
        streaming_bit_depth: Optional[int] = None,
        max_in_flight: int = 2,
        prefetch_depth: int = 2,
        upload_prefetch: bool = True,
        wire_format: str = "uint16",
        dispatch_chunk: int = 1,
        chunk_strategy: str = "auto",
        metrics_window_s: float = 5.0,
        on_metrics: Optional[Callable[[ThroughputStats], None]] = None,
        on_processed: Optional[Callable[[np.ndarray, int], None]] = None,
        on_volume: Optional[Callable[[np.ndarray, int], None]] = None,
        on_info: Optional[Callable[[str], None]] = None,
    ):
        self.model = model
        self.source = source
        self.extensions = extensions or ExtensionManager()
        self.stream_to_host = stream_to_host
        self.streaming_skip = streaming_skip
        self.streaming_bit_depth = streaming_bit_depth or model.acq.bit_depth
        self.max_in_flight = max(1, max_in_flight)
        self.prefetch_depth = prefetch_depth
        # pipelined H2D on the upload thread (_DeviceFeeder)
        self.upload_prefetch = upload_prefetch and not model.is_multihost
        # "packed12": the source yields packed-12-bit wire buffers (uint8,
        # 1.5 bytes/sample), uploaded packed and unpacked on the device.  The
        # raw RECORDER keeps the wire bytes verbatim; raw-data EXTENSIONS
        # receive unpacked sample values.
        if wire_format not in ("uint16", "packed12"):
            raise ValueError("wire_format must be 'uint16' or 'packed12'")
        self.wire_format = wire_format
        # >1: this many buffers per process_chunk call (throughput mode);
        # costs dispatch_chunk buffers of latency.  chunk_strategy "auto"
        # takes the one-kernel batch whenever the configuration allows it.
        self.dispatch_chunk = max(1, dispatch_chunk)
        self.chunk_strategy = chunk_strategy
        self.on_metrics = on_metrics
        self.on_processed = on_processed
        self.on_info = on_info or (lambda msg: None)

        self.raw_recorder = Recorder("raw")
        self.processed_recorder = Recorder("processed")
        self._record_as_float = False
        self._stop_after_record = False
        self.scheduler: Optional[RecordingScheduler] = None
        self.assembler = None  # d_processedBuffer analog (cuda_code.cu:1530-1535)
        if on_volume is not None:
            from .io.volume import VolumeAssembler

            self.assembler = VolumeAssembler(model.acq, on_volume=on_volume)
        wire_bytes = (model.acq.samples_per_buffer * 3 // 2
                      if wire_format == "packed12"
                      else model.acq.bytes_per_buffer)
        self.meter = ThroughputMeter(model.acq, metrics_window_s,
                                     wire_bytes_per_buffer=wire_bytes)
        self.running = False
        self._stop_requested = threading.Event()
        # post-process background capture (cuda_code.cu:743-755, 1556-1562)
        self._post_bg_remaining = 0
        self._post_bg_total = 0
        self._post_bg_accum = None
        self._d2h: Optional[torch.cuda.Stream] = None  # made in run()

    # -- recording (octprozapp.cpp:215-299 / processing.cpp:231-267) --------
    def start_recording(self, params: RecordingParams) -> None:
        if params.save_screenshots:
            raise NotImplementedError(
                "recording screenshots need the viewer's renderer, which is not "
                "ported yet (ROADMAP.md Queue 1, A12)")
        ts = time.strftime("%Y%m%d_%H%M%S")
        if params.save_raw:
            self.raw_recorder.start(params, ts)
        if params.save_processed:
            self.processed_recorder.start(params, ts)
            self._record_as_float = params.save_as_32bit_float
        self._stop_after_record = params.stop_after_record
        if params.save_meta:
            prefix = os.path.join(params.save_dir, f"{ts}_{params.name}")
            write_meta(prefix, self.model.acq, self.model.cfg, params)
            if params.settings_file:
                # the reference's metadata is a COPY of settings.ini
                # (octprozapp.cpp:295-298)
                try:
                    shutil.copyfile(params.settings_file, prefix + "_settings.ini")
                except OSError as e:
                    self.on_info(f"settings-file copy failed: {e}")
        self.on_info(f"recording started: {params.name}")

    def schedule_recordings(self, params: RecordingParams, delay_s: float = 0.0,
                            interval_s: float = 60.0, total: int = 1,
                            retry_s: float = 10.0) -> None:
        """Timer-driven recording series (recordingscheduler.cpp:131-155),
        polled from the run loop."""

        def start() -> bool:
            if self.recording:
                return False  # overlap protection
            # stop_after_record is honoured only on the final recording of
            # the series (octprozapp.cpp:424-446)
            last = (self.scheduler is None
                    or self.scheduler.done >= self.scheduler.total - 1)
            self.start_recording(
                params if last else
                dataclasses.replace(params, stop_after_record=False))
            return True

        self.scheduler = RecordingScheduler(start, delay_s, interval_s, total,
                                            retry_s)
        self.scheduler.start()

    @property
    def recording(self) -> bool:
        return self.raw_recorder.recording or self.processed_recorder.recording

    # -- post-process background capture (cuda_code.cu:743-767, 1556-1568) --
    def record_post_background(self, n_buffers: int = 1) -> None:
        """Capture the mean A-scan of the next ``n_buffers`` processed
        buffers and install it as the post-process background curve
        (cuda_code.cu:1556-1568).  Record with removal off or weight 0: with
        removal active the captured curve includes it (warned)."""
        if n_buffers < 1:
            raise ValueError("n_buffers must be >= 1")
        if self.model.cfg.post_background_removal:
            self.on_info("warning: post-background capture while removal is "
                         "active records the already-corrected stream")
        self._post_bg_total = n_buffers
        self._post_bg_remaining = n_buffers
        self._post_bg_accum = None

    def _capture_post_background(self, processed) -> None:
        bg = postprocess.get_background(processed)  # on the device
        self._post_bg_accum = (bg if self._post_bg_accum is None
                               else self._post_bg_accum + bg)
        self._post_bg_remaining -= 1
        if self._post_bg_remaining == 0:
            avg = self.model.fetch(self._post_bg_accum).astype(np.float32) \
                / self._post_bg_total
            self.model.set_post_background(avg)
            self._post_bg_accum = None
            self.on_info(f"post-process background recorded "
                         f"({self._post_bg_total} buffers averaged)")

    def stop(self) -> None:
        """Request the run loop to exit (octprozapp.cpp slot_stop analog)."""
        self._stop_requested.set()

    # -- device-to-host ------------------------------------------------------
    def _start_fetch(self, t: torch.Tensor) -> torch.Tensor:
        """Begin the device-to-host copy of ``t``; the returned host tensor
        holds the data once the entry's event completed."""
        if self._d2h is None:  # CPU model: already on the host
            return t
        self._d2h.wait_stream(torch.cuda.current_stream(self.model.device))
        with torch.cuda.stream(self._d2h):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
        t.record_stream(self._d2h)
        return host

    def _mark_done(self, fetched: bool) -> Optional[torch.cuda.Event]:
        """The event that completes after this step (and its fetches)."""
        if self._d2h is None:
            return None
        done = torch.cuda.Event()
        done.record(self._d2h if fetched
                    else torch.cuda.current_stream(self.model.device))
        return done

    # -- the hot loop (processing.cpp:176-218) ------------------------------
    def run(self, max_buffers: Optional[int] = None) -> int:
        """Drive the stream until the source ends, ``max_buffers`` is hit, or
        :meth:`stop` is called.  Returns the number of buffers processed.
        An error of the source or of the upload propagates out of here."""
        acq = self.model.acq
        bufs_per_vol = max(acq.buffers_per_volume, 1)
        cuda = self.model.device.type == "cuda"
        if cuda:
            self._d2h = torch.cuda.Stream(self.model.device)

        def want_raw_fanout() -> bool:
            # per buffer: an extension activated mid-stream starts receiving
            # raw data immediately
            return any(e.active and e.wants_raw_data
                       for e in self.extensions.extensions.values())

        prefetcher = _Prefetcher(self.source, self.prefetch_depth)
        prefetcher.start()
        feeder = None
        if self.upload_prefetch:
            # room for a whole chunk ahead: a chunk is dispatched only once
            # all its buffers are on the device
            depth = max(self.prefetch_depth, self.dispatch_chunk)
            feeder = _DeviceFeeder(prefetcher, self.model, depth=depth,
                                   wire_format=self.wire_format, ring=depth + 1)
            feeder.start()
        self._stop_requested.clear()
        self.running = True

        # In-flight steps awaiting the host: (buffer_nr, host float32 or None,
        # host quantized or None, record_quant, done event or None).  At most
        # max_in_flight -- the back-pressure of the blocking CUDA event
        # (cuda_code.cu:1416-1420).
        in_flight: List[tuple] = []
        processed_count = 0
        chunk_raws: List = []

        def dispatch_one(processed, buffer_nr: int) -> None:
            nonlocal processed_count
            if self._post_bg_remaining > 0:
                self._capture_post_background(processed)

            # Two independent D2H streams, like the reference's separate
            # streamProcessedFloatData / streamProcessedData kernels
            # (cuda_code.cu:1595-1604): the float32 recorder stream (every
            # buffer while recording) and the quantized consumer stream
            # (skip-N decimated).  Recording the quantized stream fetches
            # every buffer regardless of stream_to_host (octprozapp.cpp:
            # 408-416).  record_quant is decided HERE, at enqueue: a
            # recording started while these buffers are in flight must not
            # swallow pre-start data.
            recording = self.processed_recorder.recording
            record_float = recording and self._record_as_float
            record_quant = recording and not self._record_as_float
            stream_due = (self.stream_to_host
                          and processed_count % (self.streaming_skip + 1) == 0)
            host_float = self._start_fetch(processed) if record_float else None
            host_quant = (self._start_fetch(quantize_mod.quantize(
                processed, self.streaming_bit_depth))
                if (record_quant or stream_due) else None)
            fetched = host_float is not None or host_quant is not None
            in_flight.append((buffer_nr, host_float, host_quant, record_quant,
                              self._mark_done(fetched)))
            if len(in_flight) > self.max_in_flight:
                self._drain_one(in_flight)

            processed_count += 1
            if self._stop_after_record and not self.recording:
                # auto-stop once the recording finished (REC_STOP,
                # octprozapp.cpp:424-446)
                self._stop_after_record = False
                self.on_info("recording complete: stopping stream")
                self._stop_requested.set()
            if self.scheduler is not None and self.scheduler.active:
                self.scheduler.poll()
            stats = self.meter.tick()
            if stats is not None:
                self.on_info(stats.info_line())
                if self.on_metrics:
                    self.on_metrics(stats)

        def flush_chunk() -> None:
            """Dispatch the accumulated raw buffers as one process_chunk
            call; a partial tail runs buffer by buffer, as in the JAX
            package."""
            if not chunk_raws:
                return
            if len(chunk_raws) < self.dispatch_chunk:
                for raw in chunk_raws:
                    if self._stop_requested.is_set():
                        break
                    dispatch_one(self.model.process_buffer(raw),
                                 processed_count % bufs_per_vol)
            else:
                first_nr = processed_count % bufs_per_vol
                # uploaded buffers are stacked on the device
                stack = (torch.stack(chunk_raws)
                         if isinstance(chunk_raws[0], torch.Tensor)
                         else np.stack(chunk_raws))
                outs = self.model.process_chunk(stack, strategy=self.chunk_strategy)
                for i in range(outs.shape[0]):
                    if self._stop_requested.is_set():
                        break  # stop() / stop_after_record honoured mid-chunk
                    dispatch_one(outs[i], (first_nr + i) % bufs_per_vol)
            chunk_raws.clear()

        try:
            while not self._stop_requested.is_set():
                if max_buffers is not None and \
                        processed_count + len(chunk_raws) >= max_buffers:
                    break
                if feeder is not None:
                    item = feeder.get(stop=self._stop_requested)
                    if item is None:
                        break
                    raw, dev, uploaded = item
                    if uploaded is not None:
                        compute = torch.cuda.current_stream(self.model.device)
                        compute.wait_event(uploaded)
                        dev.record_stream(compute)
                else:
                    raw = prefetcher.get(stop=self._stop_requested)
                    if raw is None:
                        break
                    # inline upload on the loop thread (no feeder)
                    dev = (self.model.put_packed_buffer(raw)
                           if self.wire_format == "packed12" else raw)
                buffer_nr = (processed_count + len(chunk_raws)) % bufs_per_vol

                # raw-side subscribers get the host buffer
                # (processing.cpp:182 emit rawData): the recorder the wire
                # bytes verbatim, extensions sample values
                if self.raw_recorder.recording:
                    self.raw_recorder.record_buffer(raw, buffer_nr)
                if want_raw_fanout():
                    host_raw = np.asarray(raw)
                    if self.wire_format == "packed12":
                        host_raw = unpack_uint12_packed(
                            host_raw.reshape(-1),
                            acq.samples_per_buffer).reshape(acq.buffer_shape)
                    self.extensions.feed_raw(host_raw, acq, buffer_nr)

                if self.dispatch_chunk > 1:
                    chunk_raws.append(dev if isinstance(dev, torch.Tensor)
                                      else np.asarray(raw))
                    if len(chunk_raws) >= self.dispatch_chunk:
                        flush_chunk()
                    continue

                dispatch_one(self.model.process_buffer(dev), buffer_nr)

            if not self._stop_requested.is_set():
                flush_chunk()  # partial tail (single-buffer mode: no-op)
            while in_flight:
                self._drain_one(in_flight)
            if cuda:  # everything dispatched has executed
                torch.cuda.current_stream(self.model.device).synchronize()
            # end-of-stream flush: a source that ends before
            # buffers_to_record must not silently discard the capture
            for rec in (self.raw_recorder, self.processed_recorder):
                if rec.recording:
                    path = rec.flush()
                    self.on_info(
                        "stream ended mid-recording: "
                        + (f"partial {rec.name} recording saved to {path}"
                           if path else f"no {rec.name} buffers captured"))
        finally:
            self.running = False
            if feeder is not None:
                feeder.stop()
            prefetcher.stop()
        return processed_count

    def _drain_one(self, in_flight: List[tuple]) -> None:
        buffer_nr, host_float, host_quant, record_quant, done = in_flight.pop(0)
        if done is not None:
            done.synchronize()  # the step and its fetches have completed
        if host_float is not None:
            # recorder-only stream (the reference's float path feeds the
            # Recorder, not the extensions, processing.cpp:251-264); a
            # bfloat16 volume arrives as float32
            self.processed_recorder.record_buffer(self.model.fetch(host_float),
                                                  buffer_nr)
        if host_quant is not None:
            host = self.model.fetch(host_quant)
            if record_quant and self.processed_recorder.recording:
                self.processed_recorder.record_buffer(host, buffer_nr)
            self.extensions.feed_processed(host, self.model.acq,
                                           self.streaming_bit_depth, buffer_nr)
            if self.assembler is not None:
                self.assembler.add(
                    quantize_mod.dequantize(host, self.streaming_bit_depth),
                    buffer_nr)
            if self.on_processed:
                self.on_processed(host, buffer_nr)
