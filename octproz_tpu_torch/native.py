"""ctypes bindings for the port's native host-runtime library
(``csrc/octnative.cpp``).

Counterpart of ``octproz_tpu/native.py``: the reference's data path below
Qt is native C++ (aligned double buffer,
octproz_devkit/src/acquisitionbuffer.cpp; streaming file reads,
virtualoctsystem.cpp:226-291), and this module provides the same
components for the port's host loop: the 128-byte-aligned ring with atomic
ready flags, positional file reads and the packed 12-bit unpack and pack.

The library is compiled at first use with ``g++`` into
``_build/native/<hash>/liboctnative.so`` inside this package (gitignored),
the hash taken over the source, the flags and the host CPU: code built with
``-march=native`` runs only on the kind of CPU that built it.  ``g++``
writes a temporary name in that directory, which ``os.replace`` then moves
into place, so a concurrent process (another test worker) never loads a
half-written file.  Without ``g++`` the file reads and the 12-bit unpack
and pack fall back to numpy; :class:`NativeRingBuffer` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "octnative.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_lib_lock = threading.Lock()


def _host_cpu() -> str:
    """What ``-march=native`` resolves from: the machine and the first
    processor's vendor, model and feature flags."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor only
                if line.startswith(("vendor_id", "model name", "flags", "Features")):
                    keep.append(line.strip())
    except OSError:
        pass
    return "\n".join([platform.machine(), platform.processor(), *keep])


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "liboctnative.so"


def _build(lib: Path) -> bool:
    """Compile the library to a temporary name of this process and thread
    beside ``lib`` and move it into place (atomic on one file system)."""
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_slot_ptr.restype = ctypes.c_void_p
    lib.rb_slot_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("rb_acquire_write", "rb_acquire_read"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    for name in ("rb_commit_write", "rb_release_read"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("rb_produced", "rb_consumed"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    lib.file_read_at.restype = ctypes.c_long
    lib.file_read_at.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                 ctypes.c_void_p]
    for name in ("unpack_uint12", "pack_uint12"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The native library (built at first use), or None if ``g++`` cannot
    build it."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = library_path()
        if not lib.exists() and not _build(lib):
            _build_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(lib)))
        except OSError:
            _build_failed = True
        return _lib


def native_available() -> bool:
    return load_library() is not None


class NativeRingBuffer:
    """Aligned N-slot ring with atomic ready flags -- the AcquisitionBuffer
    analog (acquisitionbuffer.h:53-58).  Slots are zero-copy numpy views of
    128-byte-aligned native memory, so a producer (acquisition hardware
    thread, file prefetch) can fill a slot while the consumer feeds the
    previous one to the device."""

    def __init__(self, n_slots: int, slot_shape, dtype, alignment: int = 128):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable (g++ build failed)")
        self._lib = lib
        self.slot_shape = tuple(slot_shape)
        self.dtype = np.dtype(dtype)
        slot_bytes = int(np.prod(self.slot_shape)) * self.dtype.itemsize
        self._handle = lib.rb_create(n_slots, slot_bytes, alignment)
        if not self._handle:
            raise MemoryError("rb_create failed")
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self._views = []
        for i in range(n_slots):
            ptr = lib.rb_slot_ptr(self._handle, i)
            buf = (ctypes.c_uint8 * slot_bytes).from_address(ptr)
            self._views.append(np.frombuffer(buf, dtype=self.dtype).reshape(self.slot_shape))

    def acquire_write(self) -> int:
        """Next writable slot index, or -1 if the consumer is behind."""
        return self._lib.rb_acquire_write(self._handle)

    def commit_write(self, slot: int) -> None:
        self._lib.rb_commit_write(self._handle, slot)

    def acquire_read(self) -> int:
        """Next ready slot index, or -1 if none ready."""
        return self._lib.rb_acquire_read(self._handle)

    def release_read(self, slot: int) -> None:
        self._lib.rb_release_read(self._handle, slot)

    def produced(self) -> int:
        """Total slots ever committed (monotonic)."""
        return self._lib.rb_produced(self._handle)

    def consumed(self) -> int:
        """Total slots ever released (monotonic)."""
        return self._lib.rb_consumed(self._handle)

    def view(self, slot: int) -> np.ndarray:
        """Zero-copy numpy view of a slot."""
        return self._views[slot]

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._views = []
            self._lib.rb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_file_at(path: str, offset: int, nbytes: int,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """``nbytes`` bytes of ``path`` at ``offset`` as uint8, read into
    ``out`` when given (a native pread loop; numpy without the library);
    EOFError on a short file."""
    if out is None:
        out = np.empty(nbytes, np.uint8)
    lib = load_library()
    if lib is not None:
        got = lib.file_read_at(os.fsencode(path), offset, nbytes,
                               out.ctypes.data_as(ctypes.c_void_p))
        if got < 0:
            raise OSError(f"file_read_at failed for {path}")
        if got < nbytes:
            raise EOFError(f"{path}: wanted {nbytes} bytes at {offset}, got {got}")
        return out
    data = np.fromfile(path, dtype=np.uint8, count=nbytes, offset=offset)
    if data.size < nbytes:
        raise EOFError(f"{path}: wanted {nbytes} bytes at {offset}, got {data.size}")
    out[:nbytes] = data
    return out


def unpack_uint12(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """12-bit packed (2 samples / 3 bytes) -> uint16; native with a numpy
    fallback (``ops.convert.unpack_uint12_packed``)."""
    packed = np.ascontiguousarray(packed, np.uint8)
    # size check BEFORE handing the pointer to C: an undersized buffer
    # would be a silent out-of-bounds read (an odd tail needs 2 bytes,
    # csrc/octnative.cpp unpack_uint12)
    needed = 3 * (n_samples // 2) + (2 if n_samples & 1 else 0)
    if packed.size < needed:
        raise ValueError(
            f"packed 12-bit buffer too small: {n_samples} samples need "
            f"{needed} bytes, have {packed.size}")
    lib = load_library()
    if lib is None:
        from .ops.convert import unpack_uint12_packed

        return unpack_uint12_packed(packed, n_samples)
    out = np.empty(n_samples, np.uint16)
    lib.unpack_uint12(packed.ctypes.data_as(ctypes.c_void_p),
                      out.ctypes.data_as(ctypes.c_void_p), n_samples)
    return out


def pack_uint12(samples: np.ndarray) -> np.ndarray:
    """uint16 12-bit samples -> packed bytes (fixture/recording helper);
    native with a numpy fallback (``ops.convert.pack_uint12``)."""
    samples = np.ascontiguousarray(samples, np.uint16).reshape(-1)
    lib = load_library()
    if lib is None:
        from .ops.convert import pack_uint12 as pack_numpy

        return pack_numpy(samples)
    n = samples.size
    out = np.zeros((n + 1) // 2 * 3, np.uint8)
    lib.pack_uint12(samples.ctypes.data_as(ctypes.c_void_p),
                    out.ctypes.data_as(ctypes.c_void_p), n)
    return out
