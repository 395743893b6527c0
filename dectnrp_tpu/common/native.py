"""ctypes bindings for the native host runtime (native/dectnrp_rt.cc).

The device compute path is JAX/XLA/Pallas; the host-side real-time plumbing —
IQ ring buffer, MPMC job queue, FIFO token, datagram queues — is C++ like the
reference's runtime (lib/src/radio/buffer_rx.cpp, phy/pool/job_queue*.cpp,
phy/pool/token.cpp, application/queue/queue.cpp). The shared library builds
lazily on first use with g++ and is cached next to the source; every class
here has identical semantics to its pure-Python fallback twin so the
framework stays importable without a toolchain (`native_available()`).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "dectnrp_rt.cc"
_LIB = _SRC.with_suffix(".so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> Path | None:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++20", "-shared", "-fPIC", "-pthread",
             "-fvisibility=hidden", str(_SRC), "-o", str(_LIB)],
            check=True, capture_output=True, timeout=120)
        return _LIB
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        c = ctypes.c_void_p
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(i64)
        sigs = {
            "rb_create": ([i64, i32], c), "rb_destroy": ([c], None),
            "rb_time": ([c], i64), "rb_write": ([c, fp, i64], i32),
            "rb_read": ([c, fp, i64, i64], i32),
            "rb_wait_until_nto": ([c, i64, i64], i64),
            "rb_shutdown": ([c], None),
            "jq_create": ([i64], c), "jq_destroy": ([c], None),
            "jq_enqueue": ([c, i32, i32, i64], i64),
            "jq_dequeue": ([c, i64p, i64], i32),
            "jq_size": ([c], i64), "jq_set_permeable": ([c, i32], None),
            "jq_shutdown": ([c], None),
            "tok_create": ([], c), "tok_destroy": ([c], None),
            "tok_lock": ([c, i32, i64], i32),
            "tok_lock_fifo": ([c, i32, i64, i64], i32),
            "tok_unlock": ([c], None),
            "dq_create": ([i64, i64], c), "dq_destroy": ([c], None),
            "dq_push": ([c, u8p, i64], i32),
            "dq_pop": ([c, u8p, i64, i64], i64),
            "dq_size": ([c], i64), "dq_dropped": ([c], i64),
            "dq_shutdown": ([c], None),
            "iqp_create_file": ([c, ctypes.c_char_p, i64, ctypes.c_double], c),
            "iqp_samples": ([c], i64), "iqp_late_chunks": ([c], i64),
            "iqp_eof": ([c], i32), "iqp_destroy": ([c], None),
            "iqp_create_socket": ([c, ctypes.c_uint16, i64], c),
            "iqps_samples": ([c], i64), "iqps_datagrams": ([c], i64),
            "iqps_malformed": ([c], i64), "iqp_destroy_socket": ([c], None),
            "txc_create_file": ([ctypes.c_char_p, i32, i64,
                                 ctypes.c_double, i32], c),
            "txc_create_socket": ([ctypes.c_uint16, i32, i64,
                                   ctypes.c_double, i32], c),
            "txc_schedule": ([c, i64, i64, fp, i64], i32),
            "txc_emitted": ([c], i64), "txc_late": ([c], i64),
            "txc_order_violations": ([c], i64),
            "txc_send_errors": ([c], i64), "txc_start": ([c], None),
            "txc_destroy": ([c], None),
            "dectnrp_rt_abi_version": ([], i32),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name, None)
            if fn is None:
                return None
            fn.argtypes = argtypes
            fn.restype = restype
        if lib.dectnrp_rt_abi_version() != 2:
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeRingBuffer:
    """SPMC IQ ring buffer; global time IS the 64-bit sample counter.

    Mirrors reference radio/buffer_rx.hpp:57-139 (get_ant_streams_next on the
    producer side, wait_until_nto + windowed read on the consumer side).
    """

    def __init__(self, capacity: int, n_ant: int = 1):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.rb_create(capacity, n_ant)
        if not self._h:
            raise MemoryError("rb_create failed")
        self.capacity = capacity
        self.n_ant = n_ant

    @property
    def time(self) -> int:
        return self._lib.rb_time(self._h)

    def write(self, iq: np.ndarray) -> None:
        """Append iq [n_ant, n] complex64 at the current ring time."""
        iq = np.ascontiguousarray(iq, dtype=np.complex64)
        if iq.ndim == 1:
            iq = iq[None, :]
        assert iq.shape[0] == self.n_ant
        buf = iq.view(np.float32)  # [n_ant, 2n] interleaved re/im
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.rb_write(self._h, ptr, iq.shape[1]) != 0:
            raise ValueError("rb_write: burst larger than ring capacity")

    def read(self, t0: int, n: int) -> np.ndarray:
        """Samples [t0, t0+n) of every antenna -> complex64 [n_ant, n]."""
        out = np.empty((self.n_ant, 2 * n), dtype=np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        rc = self._lib.rb_read(self._h, ptr, t0, n)
        if rc != 0:
            raise ValueError(f"rb_read failed (rc={rc}): range [{t0},{t0+n}) "
                             f"vs ring time {self.time} cap {self.capacity}")
        return out.view(np.complex64)

    def wait_until_nto(self, target: int, timeout_us: int = -1) -> int:
        return self._lib.rb_wait_until_nto(self._h, target, timeout_us)

    def shutdown(self) -> None:
        self._lib.rb_shutdown(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None


class NativeJobQueue:
    """MPMC FIFO job queue with fifo_cnt + permeable gate (job_queue_t)."""

    def __init__(self, capacity: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.jq_create(capacity)

    def enqueue(self, type_: int, handle: int, time64: int = 0) -> int:
        """Returns the fifo_cnt, or -1 when full / gate closed."""
        return self._lib.jq_enqueue(self._h, type_, handle, time64)

    def dequeue(self, timeout_us: int = -1):
        out = (ctypes.c_int64 * 4)()
        rc = self._lib.jq_dequeue(self._h, out, timeout_us)
        if rc != 0:
            return None
        return {"fifo_cnt": out[0], "type": int(out[1]),
                "handle": int(out[2]), "time64": out[3]}

    def __len__(self) -> int:
        return self._lib.jq_size(self._h)

    def set_permeable(self, permeable: bool) -> None:
        self._lib.jq_set_permeable(self._h, 1 if permeable else 0)

    def shutdown(self) -> None:
        self._lib.jq_shutdown(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.jq_destroy(self._h)
            self._h = None


class NativeToken:
    """FIFO-ordered firmware serialization token (token_t)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.tok_create()

    def lock(self, id_: int = 0, timeout_us: int = -1) -> bool:
        return bool(self._lib.tok_lock(self._h, id_, timeout_us))

    def lock_fifo(self, id_: int, fifo_cnt: int, timeout_us: int = -1) -> bool:
        return bool(self._lib.tok_lock_fifo(self._h, id_, fifo_cnt, timeout_us))

    def unlock(self) -> None:
        self._lib.tok_unlock(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tok_destroy(self._h)
            self._h = None


class NativeDatagramQueue:
    """Fixed-capacity datagram queue, drop-on-overflow (application/queue)."""

    def __init__(self, max_datagrams: int = 64, max_bytes: int = 1 << 20):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.dq_create(max_datagrams, max_bytes)
        self._max_bytes = max_bytes

    def push(self, data: bytes) -> bool:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.dq_push(self._h, buf, len(data)) == 0

    def pop(self, timeout_us: int = 0):
        out = (ctypes.c_uint8 * self._max_bytes)()
        n = self._lib.dq_pop(self._h, out, self._max_bytes, timeout_us)
        if n < 0:
            return None
        return bytes(out[:n])

    def __len__(self) -> int:
        return self._lib.dq_size(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.dq_dropped(self._h)

    def shutdown(self) -> None:
        self._lib.dq_shutdown(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dq_destroy(self._h)
            self._h = None


class NativeIqProducer:
    """File-driven IQ ingress thread pacing samples into a NativeRingBuffer.

    The TPU-native analog of the reference USRP RX streamer thread
    (lib/src/radio/hw_usrp.cpp:1093-1219): a native pthread reads cf32
    chunks (per antenna, interleaved re/im, `spp` samples per chunk) from a
    recorded/streamed file, writes them into the ring, paces toward
    absolute per-chunk deadlines at rate_hz (0 = free-run), and counts
    chunks that fell >1 spp behind (`late_chunks`, the overflow-accounting
    analog). Stops on EOF (`eof`).
    """

    def __init__(self, ring: NativeRingBuffer, path: str, spp: int = 2048,
                 rate_hz: float = 0.0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._ring = ring           # keep the ring alive past the producer
        self._h = lib.iqp_create_file(ring._h, str(path).encode(), spp,
                                      float(rate_hz))
        if not self._h:
            raise RuntimeError(f"iqp_create_file failed for {path!r}")

    @property
    def samples(self) -> int:
        return self._lib.iqp_samples(self._h)

    @property
    def late_chunks(self) -> int:
        return self._lib.iqp_late_chunks(self._h)

    @property
    def eof(self) -> bool:
        return bool(self._lib.iqp_eof(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.iqp_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeIqSocketProducer:
    """UDP-fed IQ ingress thread writing datagram samples into the ring.

    The NIC-fed radio analog (reference hw_usrp RX streamer over 10GbE,
    hw_usrp.cpp:1093-1219): datagrams of whole cf32 samples (per antenna,
    interleaved re/im) arrive on a loopback UDP port; the sender's rate IS
    the clock. Malformed datagrams (fractional sample counts) are counted
    and dropped.
    """

    def __init__(self, ring: NativeRingBuffer, port: int,
                 max_samples_per_dgram: int = 4096):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._ring = ring
        self._h = lib.iqp_create_socket(ring._h, port, max_samples_per_dgram)
        if not self._h:
            raise RuntimeError(f"iqp_create_socket failed on port {port}")

    @property
    def samples(self) -> int:
        return self._lib.iqps_samples(self._h)

    @property
    def datagrams(self) -> int:
        return self._lib.iqps_datagrams(self._h)

    @property
    def malformed(self) -> int:
        return self._lib.iqps_malformed(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.iqp_destroy_socket(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeTxConsumer:
    """Paced TX egress thread with strict tx_order_id discipline.

    The radio TX side (reference hw_usrp.cpp:867-877 timed bursts +
    buffer_tx_pool.cpp:69-135 in-order transmission): scheduled bursts are
    admitted strictly in order-id sequence and mixed over zeros into
    fixed-size chunks emitted at rate_hz toward a cf32 file or a loopback
    UDP port. Bursts scheduled behind the emit cursor count late (their
    elapsed head is dropped, the UHD late-command analog).
    """

    def __init__(self, sink: str, n_ant: int = 1, spp: int = 2048,
                 rate_hz: float = 1_920_000.0, deferred_start: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        d = 1 if deferred_start else 0
        if sink.startswith("udp:"):
            self._h = lib.txc_create_socket(int(sink[4:]), n_ant, spp,
                                            float(rate_hz), d)
        else:
            self._h = lib.txc_create_file(str(sink).encode(), n_ant, spp,
                                          float(rate_hz), d)
        if not self._h:
            raise RuntimeError(f"tx consumer creation failed for {sink!r}")
        self.n_ant = n_ant

    def start(self) -> None:
        """Release a deferred-start pacer: sample 0 of the emit cursor is
        NOW. Call when the first RX sample lands so TX and RX clocks share
        an origin (they always shared a rate, never an origin — the r04
        advisor's timebase-misalignment finding)."""
        self._lib.txc_start(self._h)

    def schedule(self, order_id: int, tx_time: int, iq: np.ndarray) -> None:
        iq = np.ascontiguousarray(iq, dtype=np.complex64)
        if iq.ndim == 1:
            iq = iq[None, :]
        if iq.shape[0] < self.n_ant:
            # fewer TX streams than radio antennas (e.g. a SISO beacon on a
            # multi-antenna radio): unused antennas transmit zeros
            iq = np.concatenate([iq, np.zeros(
                (self.n_ant - iq.shape[0], iq.shape[1]), np.complex64)])
        iq = np.ascontiguousarray(iq[: self.n_ant])
        buf = iq.view(np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.txc_schedule(self._h, order_id, tx_time, ptr,
                                  iq.shape[1]) != 0:
            raise ValueError(f"tx order id {order_id} violates the "
                            "in-order transmission discipline")

    @property
    def emitted(self) -> int:
        return self._lib.txc_emitted(self._h)

    @property
    def late_bursts(self) -> int:
        return self._lib.txc_late(self._h)

    @property
    def order_violations(self) -> int:
        return self._lib.txc_order_violations(self._h)

    @property
    def send_errors(self) -> int:
        return self._lib.txc_send_errors(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.txc_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
