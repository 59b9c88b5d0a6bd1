"""paddle.distributed.rpc (counterpart of ``paddle_tpu/distributed/rpc.py``;
reference: python/paddle/distributed/rpc/rpc.py: init_rpc, rpc_sync,
rpc_async, shutdown over a brpc transport).

The transport is plain TCP and pickle with a threaded server in each
process (user RPC is a control-plane feature: tensors move through the
collectives), and the worker registry is ``torch.distributed.TCPStore``
hosted by rank 0. The API and semantics (named workers, synchronous and
asynchronous calls, a barrier at shutdown) are the reference's. Calls
unpickle what the job's own workers sent: serve only a trusted job.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional

import torch.distributed as dist

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown", "get_worker_info",
           "get_all_worker_infos", "WorkerInfo"]


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    name: str
    rank: int
    ip: str
    port: int


_state: Dict[str, Any] = {}


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> bytes:
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _serve_loop(server: socket.socket, stop: threading.Event):
    while not stop.is_set():
        try:
            conn, _ = server.accept()
        except OSError:
            return
        threading.Thread(target=_serve_one, args=(conn,), daemon=True).start()


def _serve_one(conn: socket.socket):
    try:
        with conn:
            fn, args, kwargs = pickle.loads(_recv_msg(conn))
            try:
                result = (True, fn(*args, **kwargs))
            except Exception as e:  # noqa: BLE001 - marshalled to the caller
                result = (False, e)
            _send_msg(conn, pickle.dumps(result, protocol=4))
    except ConnectionError:
        pass


def _barrier(store, key: str, world: int, timeout: float) -> None:
    """Every rank's arrival at ``key``, from the store's ``add`` and
    ``wait``: the last to arrive sets the release key."""
    if store.add(key + "/count", 1) == world:
        store.set(key + "/done", "1")
    store.wait([key + "/done"], datetime.timedelta(seconds=timeout))


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None) -> None:
    """Start this process's RPC server and register with the job
    (reference rpc.init_rpc). Rank 0 hosts the registry at
    ``master_endpoint`` (``PADDLE_MASTER_ENDPOINT``; a world of one may
    leave it to a free port)."""
    rank = rank if rank is not None else int(
        os.environ.get("PADDLE_TRAINER_ID", "0"))
    world_size = world_size or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER_ENDPOINT") or "127.0.0.1:0"
    host, port_s = master_endpoint.rsplit(":", 1)

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("0.0.0.0", 0))
    server.listen(64)
    my_port = server.getsockname()[1]

    store = dist.TCPStore("127.0.0.1" if rank == 0 else host, int(port_s),
                          world_size, is_master=(rank == 0),
                          timeout=datetime.timedelta(seconds=300),
                          wait_for_workers=False)
    my_ip = ("127.0.0.1" if world_size == 1 or host in ("127.0.0.1",
                                                        "localhost")
             else socket.gethostbyname(socket.gethostname()))
    store.set(f"rpc/worker/{rank}",
              pickle.dumps(WorkerInfo(name, rank, my_ip, my_port)))
    store.set(f"rpc/name/{name}", str(rank))

    stop = threading.Event()
    t = threading.Thread(target=_serve_loop, args=(server, stop), daemon=True)
    t.start()

    workers: Dict[str, WorkerInfo] = {}
    for r in range(world_size):
        info = pickle.loads(store.get(f"rpc/worker/{r}"))
        workers[info.name] = info

    _state.update(dict(store=store, server=server, stop=stop, thread=t,
                       name=name, rank=rank, world_size=world_size,
                       workers=workers,
                       pool=concurrent.futures.ThreadPoolExecutor(8)))


def get_worker_info(name: Optional[str] = None) -> WorkerInfo:
    if not _state:
        raise RuntimeError("init_rpc not called")
    if name is None:
        name = _state["name"]
    return _state["workers"][name]


def get_all_worker_infos():
    if not _state:
        raise RuntimeError("init_rpc not called")
    return sorted(_state["workers"].values(), key=lambda w: w.rank)


def _call(to: str, fn, args, kwargs, timeout: float):
    info = get_worker_info(to)
    with socket.create_connection((info.ip, info.port), timeout=timeout) as s:
        _send_msg(s, pickle.dumps((fn, args or (), kwargs or {}), protocol=4))
        s.settimeout(timeout)
        ok, result = pickle.loads(_recv_msg(s))
    if not ok:
        raise result
    return result


def rpc_sync(to: str, fn, args=None, kwargs=None, timeout: float = 180.0):
    """Blocking remote call (reference rpc.rpc_sync). ``fn`` must be
    picklable by reference (a module-level function)."""
    return _call(to, fn, args, kwargs, timeout)


def rpc_async(to: str, fn, args=None, kwargs=None, timeout: float = 180.0):
    """A Future of the remote call (reference rpc.rpc_async)."""
    return _state["pool"].submit(_call, to, fn, args, kwargs, timeout)


def shutdown(graceful: bool = True) -> None:
    """A barrier (when graceful), then stop serving (reference
    rpc.shutdown)."""
    if not _state:
        return
    try:
        if graceful:
            store = _state["store"]
            world = _state["world_size"]
            _barrier(store, "rpc_shutdown", world, 120)
            store.add("rpc/shutdown_acks", 1)
            if _state["rank"] == 0 and world > 1:
                # rank 0 hosts the store: keep it up until every rank has
                # left the barrier, or their waits race its teardown
                deadline = time.time() + 120
                while time.time() < deadline:
                    if store.add("rpc/shutdown_acks", 0) >= world:
                        break
                    time.sleep(0.05)
    finally:
        _state["stop"].set()
        try:
            _state["server"].close()
        except OSError:
            pass
        _state["pool"].shutdown(wait=False)
        _state.clear()
