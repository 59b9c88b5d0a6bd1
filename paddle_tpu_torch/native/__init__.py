"""Native host runtime (C++ via ctypes; counterpart of
``paddle_tpu/native/__init__.py``).

The port's compute runs on the card through its CUDA kernels; this
package is the *host-side* native runtime around it, the reference's C++
pieces:

- :class:`TCPStore` — rendezvous KV store for multi-host bootstrap
  (reference: paddle/phi/core/distributed/store/tcp_store.h:121). The
  port's launcher and rpc run on ``torch.distributed.TCPStore``; this
  one is the JAX package's, for code that uses ``native`` directly.
- :class:`ShmRing` — process-shared-memory ring buffer carrying
  serialized batches from dataloader worker processes to the trainer
  (reference: paddle/fluid/memory/allocation/mmap_allocator.*), the
  transport of ``DataLoader(use_shared_memory=True, num_workers > 0)``.
- :func:`normalize_images` / :func:`pad_sequences` / :func:`gather_rows`
  — parallel C++ batch-assembly loops (reference:
  paddle/fluid/framework/data_feed.cc).
- :class:`HostPool` — stats-tracking host staging allocator
  (reference: paddle/fluid/memory/allocation/allocator_facade.h:45).

The shared library is the port's copy of the C++ source
(``paddle_tpu_torch/csrc/pt_native.cc``, the same C ABI), compiled with
``g++`` at first use into ``build/torch_kernels/libpt_native-<hash>.so``
(the source's sha256, so an edited source builds anew) under a file
lock, so processes that start together build it once. It needs no
``nvcc`` and no card. When the build fails, :func:`is_available` is
False and :func:`build_error` holds g++'s stderr; every entry point
then raises with it (nothing falls back to a Python path quietly).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pt_native.cc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-fvisibility=hidden", "-pthread",
             "-shared"]

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def library_path(src: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """The library built from ``src``: named by the source's sha256."""
    digest = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:16]
    return Path(build_dir) / f"libpt_native-{digest}.so"


def _build(src: Path = SOURCE, build_dir: Path = BUILD_DIR) -> str | None:
    """Compile the shared library unless it exists. Returns an error
    string or None on success."""
    if not src.exists():
        return f"source not found: {src}"
    out = library_path(src, build_dir)
    if out.exists():
        return None
    import fcntl
    build_dir.mkdir(parents=True, exist_ok=True)
    # cross-process exclusion: spawn-context dataloader workers (and
    # test workers) may load this module while another is mid-build
    with open(str(out) + ".lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if out.exists():     # another process built it while we waited
                return None
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", *CXX_FLAGS, str(src), "-o", tmp, "-lrt"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                return f"g++ invocation failed: {e}"
            if proc.returncode != 0:
                return f"g++ failed:\n{proc.stderr[-4000:]}"
            os.replace(tmp, out)
            return None
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(str(library_path()))
        c = ctypes
        u64p = c.POINTER(c.c_uint64)
        sigs = {
            "pt_store_server_start": (c.c_void_p, [c.c_int]),
            "pt_store_server_port": (c.c_int, [c.c_void_p]),
            "pt_store_server_stop": (None, [c.c_void_p]),
            "pt_store_client_connect": (c.c_void_p, [c.c_char_p, c.c_int, c.c_int]),
            "pt_store_client_close": (None, [c.c_void_p]),
            "pt_store_set": (c.c_int, [c.c_void_p, c.c_char_p, c.c_void_p, c.c_uint64]),
            "pt_store_get": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_void_p,
                                         c.c_uint64, c.c_uint64, u64p]),
            "pt_store_try_get": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_void_p,
                                             c.c_uint64, u64p]),
            "pt_store_add": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_int64]),
            "pt_store_wait": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint64]),
            "pt_store_delete": (c.c_int, [c.c_void_p, c.c_char_p]),
            "pt_store_num_keys": (c.c_int64, [c.c_void_p]),
            "pt_shmring_create": (c.c_void_p, [c.c_char_p, c.c_uint64]),
            "pt_shmring_open": (c.c_void_p, [c.c_char_p]),
            "pt_shmring_push": (c.c_int, [c.c_void_p, c.c_void_p, c.c_uint64, c.c_int]),
            "pt_shmring_pop": (c.c_int64, [c.c_void_p, c.c_void_p, c.c_uint64, c.c_int]),
            "pt_shmring_next_len": (c.c_int64, [c.c_void_p]),
            "pt_shmring_size": (c.c_uint64, [c.c_void_p]),
            "pt_shmring_close": (None, [c.c_void_p]),
            "pt_shmring_destroy": (None, [c.c_void_p]),
            "pt_normalize_u8_f32": (None, [c.c_void_p, c.c_void_p, c.c_int64,
                                           c.c_int, c.c_void_p, c.c_void_p, c.c_int]),
            "pt_pad_i32": (None, [c.POINTER(c.c_void_p), c.c_void_p, c.c_int64,
                                  c.c_int64, c.c_int32, c.c_void_p, c.c_int]),
            "pt_gather_rows_f32": (None, [c.c_void_p, c.c_void_p, c.c_int64,
                                          c.c_int64, c.c_void_p, c.c_int]),
            "pt_hostpool_create": (c.c_void_p, []),
            "pt_hostpool_destroy": (None, [c.c_void_p]),
            "pt_hostpool_alloc": (c.c_void_p, [c.c_void_p, c.c_uint64]),
            "pt_hostpool_free": (c.c_int, [c.c_void_p, c.c_void_p]),
            "pt_hostpool_trim": (None, [c.c_void_p]),
            "pt_hostpool_stats": (None, [c.c_void_p, u64p, u64p, u64p, u64p]),
            "pt_native_version": (c.c_char_p, []),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def version() -> str:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"pt_native unavailable: {_build_error}")
    return lib.pt_native_version().decode()


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"pt_native unavailable: {_build_error}")
    return lib


# ---------------------------------------------------------------------------
# TCPStore
# ---------------------------------------------------------------------------

class TCPStore:
    """Rendezvous KV store (reference tcp_store.h:121 semantics: set/get/add/
    wait + barrier). ``is_master=True`` also hosts the server in-process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: float = 300.0,
                 world_size: int = 1):
        self._lib = _require()
        self._server = None
        self._timeout_ms = int(timeout * 1000)
        self.world_size = world_size
        if is_master:
            self._server = self._lib.pt_store_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
            port = self._lib.pt_store_server_port(self._server)
        self.host, self.port = host, port
        self._client = self._lib.pt_store_client_connect(
            host.encode(), port, self._timeout_ms)
        if not self._client:
            if self._server:
                self._lib.pt_store_server_stop(self._server)
            raise RuntimeError(f"TCPStore: cannot connect {host}:{port}")

    def set(self, key: str, value: bytes | str):
        if isinstance(value, str):
            value = value.encode()
        st = self._lib.pt_store_set(self._client, key.encode(), value, len(value))
        if st != 0:
            raise RuntimeError(f"TCPStore.set({key!r}) failed")

    def get(self, key: str, timeout: float | None = None) -> bytes:
        t_ms = self._timeout_ms if timeout is None else int(timeout * 1000)
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            full = ctypes.c_uint64(0)
            n = self._lib.pt_store_get(self._client, key.encode(), buf, cap,
                                       t_ms, ctypes.byref(full))
            if n >= 0:
                return buf.raw[:n]
            if n == -3:
                cap = max(full.value, cap * 2)
                continue
            if n == -1:
                raise TimeoutError(f"TCPStore.get({key!r}) timed out")
            raise RuntimeError(f"TCPStore.get({key!r}) io error")

    def try_get(self, key: str):
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            full = ctypes.c_uint64(0)
            n = self._lib.pt_store_try_get(self._client, key.encode(), buf, cap,
                                           ctypes.byref(full))
            if n >= 0:
                return buf.raw[:n]
            if n == -3:
                cap = max(full.value, cap * 2)
                continue
            if n == -1:
                return None
            raise RuntimeError(f"TCPStore.try_get({key!r}) io error")

    def add(self, key: str, delta: int = 1) -> int:
        v = self._lib.pt_store_add(self._client, key.encode(), delta)
        if v == -(2 ** 63):
            raise RuntimeError(f"TCPStore.add({key!r}) failed")
        return v

    def wait(self, key: str, timeout: float | None = None):
        t_ms = self._timeout_ms if timeout is None else int(timeout * 1000)
        st = self._lib.pt_store_wait(self._client, key.encode(), t_ms)
        if st != 0:
            raise TimeoutError(f"TCPStore.wait({key!r}) timed out")

    def delete(self, key: str) -> bool:
        return self._lib.pt_store_delete(self._client, key.encode()) == 0

    def num_keys(self) -> int:
        return self._lib.pt_store_num_keys(self._client)

    def barrier(self, name: str = "barrier", world_size: int | None = None,
                timeout: float | None = None):
        """Reusable named barrier: the shared arrival counter never resets, so
        each n-th arrival opens a new generation key that this round waits on."""
        n = world_size or self.world_size
        arrived = self.add(f"__barrier/{name}/count", 1)
        generation = (arrived - 1) // n
        if arrived % n == 0:
            self.set(f"__barrier/{name}/done/{generation}", b"1")
        self.wait(f"__barrier/{name}/done/{generation}", timeout)

    def close(self):
        if getattr(self, "_client", None):
            self._lib.pt_store_client_close(self._client)
            self._client = None
        if getattr(self, "_server", None):
            self._lib.pt_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# ShmRing
# ---------------------------------------------------------------------------

class ShmRing:
    """Cross-process shared-memory message ring (POSIX shm + process-shared
    pthread condvars). Transport for dataloader worker→trainer batches."""

    def __init__(self, name: str | None = None, capacity: int = 64 << 20,
                 create: bool = True):
        self._lib = _require()
        self.name = name or f"/pt_ring_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        if not self.name.startswith("/"):
            self.name = "/" + self.name
        self._owner = create
        if create:
            self._h = self._lib.pt_shmring_create(self.name.encode(), capacity)
        else:
            self._h = self._lib.pt_shmring_open(self.name.encode())
        if not self._h:
            raise RuntimeError(f"ShmRing: cannot {'create' if create else 'open'} "
                               f"{self.name}")

    @classmethod
    def open(cls, name: str) -> "ShmRing":
        return cls(name=name, create=False)

    def push(self, data: bytes, timeout: float | None = None):
        t_ms = -1 if timeout is None else int(timeout * 1000)
        st = self._lib.pt_shmring_push(self._h, data, len(data), t_ms)
        if st == 1:
            raise TimeoutError("ShmRing.push timed out")
        if st == 2:
            raise BrokenPipeError("ShmRing closed")
        if st == 3:
            raise ValueError(f"message of {len(data)} bytes exceeds ring capacity")
        if st != 0:
            raise RuntimeError(f"ShmRing.push error {st}")

    def pop(self, timeout: float | None = None) -> bytes | None:
        """Returns the next message, or None when the ring is closed & drained."""
        t_ms = -1 if timeout is None else int(timeout * 1000)
        cap = max(self._lib.pt_shmring_next_len(self._h), 1 << 16)
        while True:
            buf = ctypes.create_string_buffer(int(cap))
            n = self._lib.pt_shmring_pop(self._h, buf, cap, t_ms)
            if n >= 0:
                return buf.raw[:n]
            if n == -1:
                raise TimeoutError("ShmRing.pop timed out")
            if n == -2:
                return None
            if n == -3:
                cap = self._lib.pt_shmring_next_len(self._h)
                continue
            raise RuntimeError(f"ShmRing.pop error {n}")

    def qsize_bytes(self) -> int:
        return self._lib.pt_shmring_size(self._h)

    def close(self):
        if self._h:
            self._lib.pt_shmring_close(self._h)

    def destroy(self):
        if self._h:
            self._lib.pt_shmring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# host ops
# ---------------------------------------------------------------------------

def normalize_images(images: np.ndarray, mean, std, nthreads: int = 0) -> np.ndarray:
    """(u8[..., C] / 255 - mean) / std → f32, multi-threaded in C++."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    channels = images.shape[-1]
    mean = np.ascontiguousarray(mean, dtype=np.float32).reshape(-1)
    std = np.ascontiguousarray(std, dtype=np.float32).reshape(-1)
    if mean.size == 1:
        mean = np.repeat(mean, channels)
    if std.size == 1:
        std = np.repeat(std, channels)
    lib = _require()
    out = np.empty(images.shape, dtype=np.float32)
    n_pixels = images.size // channels
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    lib.pt_normalize_u8_f32(
        images.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        n_pixels, channels, mean.ctypes.data_as(ctypes.c_void_p),
        std.ctypes.data_as(ctypes.c_void_p), nthreads)
    return out


def pad_sequences(seqs, max_len: int | None = None, pad_value: int = 0,
                  nthreads: int = 0) -> np.ndarray:
    """Pad a list of 1-D int sequences into an [n, max_len] int32 batch."""
    arrs = [np.ascontiguousarray(s, dtype=np.int32) for s in seqs]
    n = len(arrs)
    lens = np.asarray([a.size for a in arrs], dtype=np.int64)
    if max_len is None:
        max_len = int(lens.max()) if n else 0
    lib = _require()
    out = np.empty((n, max_len), dtype=np.int32)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data_as(ctypes.c_void_p).value
                                   for a in arrs])
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    lib.pt_pad_i32(ptrs, lens.ctypes.data_as(ctypes.c_void_p), n, max_len,
                   pad_value, out.ctypes.data_as(ctypes.c_void_p), nthreads)
    return out


def gather_rows(table: np.ndarray, idx: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """out[i] = table[idx[i]] for f32 2-D tables (host-side embedding gather)."""
    table = np.ascontiguousarray(table, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= table.shape[0]):
        raise IndexError(f"gather_rows: index out of range [0, {table.shape[0]})")
    lib = _require()
    out = np.empty((idx.size, table.shape[1]), dtype=np.float32)
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    lib.pt_gather_rows_f32(
        table.ctypes.data_as(ctypes.c_void_p), idx.ctypes.data_as(ctypes.c_void_p),
        idx.size, table.shape[1], out.ctypes.data_as(ctypes.c_void_p), nthreads)
    return out


# ---------------------------------------------------------------------------
# HostPool
# ---------------------------------------------------------------------------

class HostPool:
    """Free-list host staging allocator with current/peak/reserved stats
    (reference allocator_facade + memory/stats.h shape). Hands out numpy
    arrays backed by pooled 64-byte-aligned buffers."""

    def __init__(self):
        self._lib = _require()
        self._h = self._lib.pt_hostpool_create()
        self._live = {}

    def alloc(self, shape, dtype=np.float32) -> np.ndarray:
        dtype = np.dtype(dtype)
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        nbytes = int(np.prod(shape)) * dtype.itemsize
        ptr = self._lib.pt_hostpool_alloc(self._h, max(nbytes, 1))
        if not ptr:
            raise MemoryError(f"HostPool.alloc({nbytes}) failed")
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        self._live[id(arr)] = (ptr, arr)
        return arr

    def free(self, arr: np.ndarray):
        ent = self._live.pop(id(arr), None)
        if ent is None:
            raise ValueError("array not from this pool")
        self._lib.pt_hostpool_free(self._h, ent[0])

    def stats(self) -> dict:
        cur = ctypes.c_uint64(); peak = ctypes.c_uint64()
        res = ctypes.c_uint64(); allocs = ctypes.c_uint64()
        self._lib.pt_hostpool_stats(self._h, ctypes.byref(cur), ctypes.byref(peak),
                                    ctypes.byref(res), ctypes.byref(allocs))
        return {"current": cur.value, "peak": peak.value,
                "reserved": res.value, "alloc_count": allocs.value}

    def trim(self):
        self._lib.pt_hostpool_trim(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pt_hostpool_destroy(self._h)
                self._h = None
        except Exception:
            pass


__all__ = ["TCPStore", "ShmRing", "HostPool", "normalize_images",
           "pad_sequences", "gather_rows", "is_available", "build_error",
           "version", "library_path"]
