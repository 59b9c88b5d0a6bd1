"""The port's native host runtime (``paddle_tpu_torch.native``, its own
copy of ``pt_native.cc`` built with g++) against the JAX package's
(``paddle_tpu.native``): the batch helpers bit for bit on the same
numpy inputs, the TCPStore, ShmRing and HostPool cases of
``tests/test_native.py`` (each framework's client and ring against the
other's server and ring too: the same C ABI and the same wire and
shared-memory layout), the build's failure report, and the shared-memory
DataLoader against JAX's ``DataLoader(use_shared_memory=True)``.

Cross-process cases spawn children that import only
``torch_native_children`` and wait at most ``WAIT_S`` (120 s), wide for
a loaded host. Tolerances: every output exactly."""

import multiprocessing as mp
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.native as jnat
from paddle_tpu.io import DataLoader as JaxLoader
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import native as nat
from torch_native_children import (WAIT_S, Squares, ring_producer,
                                   store_child)


def test_library_builds_from_the_ports_source():
    assert nat.is_available(), nat.build_error()
    assert nat.build_error() is None
    path = nat.library_path()
    assert path.exists() and path.parent.name == "torch_kernels"
    assert nat.SOURCE.parent.name == "csrc"
    assert nat.SOURCE.parent.parent.name == "paddle_tpu_torch"
    assert nat.version() == jnat.version()


def test_build_failure_reports_gxx_stderr(tmp_path):
    bad = tmp_path / "pt_native.cc"
    bad.write_text("int broken( {\n")
    err = nat._build(bad, tmp_path / "out")
    assert err is not None and err.startswith("g++ failed")
    assert "error" in err
    assert not nat.library_path(bad, tmp_path / "out").exists()


# -- host ops ----------------------------------------------------------------

def test_normalize_images_equals_jax():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    for mean, std in (([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
                      (0.5, 0.25)):
        got = nat.normalize_images(img, mean, std)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jnat.normalize_images(img, mean,
                                                                 std))


def test_pad_sequences_equals_jax():
    seqs = [[1, 2, 3], [4], [5, 6, 7, 8, 9], []]
    for kw in ({"pad_value": -1}, {"max_len": 2, "pad_value": 0},
               {"max_len": 7, "pad_value": 3}):
        got = nat.pad_sequences(seqs, **kw)
        np.testing.assert_array_equal(got, jnat.pad_sequences(seqs, **kw))
    np.testing.assert_array_equal(nat.pad_sequences(seqs, pad_value=-1)[1],
                                  [4, -1, -1, -1, -1])


def test_gather_rows_equals_jax():
    rs = np.random.RandomState(0)
    table = rs.randn(100, 16).astype(np.float32)
    idx = rs.randint(0, 100, 57)
    got = nat.gather_rows(table, idx)
    np.testing.assert_array_equal(got, jnat.gather_rows(table, idx))
    np.testing.assert_array_equal(got, table[idx])
    with pytest.raises(IndexError):
        nat.gather_rows(table, np.array([100]))


# -- TCPStore ----------------------------------------------------------------

@pytest.mark.parametrize("server", ["port", "jax"])
def test_store_set_get_add(server):
    master = (nat if server == "port" else jnat).TCPStore(is_master=True,
                                                          timeout=10)
    client = nat.TCPStore(port=master.port, timeout=10)
    master.set("k", b"hello")
    assert client.get("k") == b"hello"
    assert client.try_get("missing") is None
    assert client.add("ctr", 5) == 5
    assert master.add("ctr", 2) == 7
    assert client.num_keys() == 2
    assert client.delete("k")
    assert client.try_get("k") is None
    client.close()
    master.close()


def test_store_wait_blocks_until_set():
    master = nat.TCPStore(is_master=True, timeout=10)
    client = nat.TCPStore(port=master.port, timeout=10)
    result = {}

    def waiter():
        t0 = time.time()
        client.wait("late_key", timeout=10)
        result["waited"] = time.time() - t0

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    master.set("late_key", b"x")
    t.join(timeout=10)
    assert "waited" in result and result["waited"] >= 0.15
    with pytest.raises(TimeoutError):
        client.get("never", timeout=0.2)
    client.close()
    master.close()


def test_store_large_value_and_barrier():
    master = nat.TCPStore(is_master=True, timeout=10, world_size=2)
    client = nat.TCPStore(port=master.port, timeout=10, world_size=2)
    blob = bytes(np.random.RandomState(0).randint(0, 256, 1 << 20,
                                                  dtype=np.uint8))
    master.set("big", blob)
    assert client.get("big") == blob
    done = []

    def rank1():
        client.barrier("b0", world_size=2, timeout=10)
        done.append(1)

    t = threading.Thread(target=rank1)
    t.start()
    time.sleep(0.1)
    master.barrier("b0", world_size=2, timeout=10)
    t.join(timeout=10)
    assert done == [1]
    client.close()
    master.close()


def test_store_cross_process():
    master = nat.TCPStore(is_master=True, timeout=WAIT_S)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=store_child, args=(master.port, q))
    p.start()
    try:
        assert master.get("from_child", timeout=WAIT_S) == b"child_data"
        master.set("from_parent", b"parent_data")
        assert q.get(timeout=WAIT_S) == b"parent_data"
        p.join(timeout=WAIT_S)
        assert p.exitcode == 0
    finally:
        if p.is_alive():
            p.kill()
        master.close()


# -- ShmRing -----------------------------------------------------------------

@pytest.mark.parametrize("reader", ["port", "jax"])
def test_shmring_roundtrip_and_wraparound(reader):
    ring = nat.ShmRing(capacity=1 << 16)
    rs = np.random.RandomState(0)
    msgs = [bytes(rs.randint(0, 256, rs.randint(1, 20000), dtype=np.uint8))
            for _ in range(50)]
    consumer = (nat if reader == "port" else jnat).ShmRing.open(ring.name)
    got = []

    def consume():
        while True:
            m = consumer.pop(timeout=10)
            if m is None:
                return
            got.append(m)

    t = threading.Thread(target=consume)
    t.start()
    for m in msgs:
        ring.push(m, timeout=10)
    ring.close()
    t.join(timeout=30)
    assert got == msgs
    consumer._h = None  # an opener must not shm_unlink; the owner does
    ring.destroy()


def test_shmring_too_large_message():
    ring = nat.ShmRing(capacity=1 << 12)
    with pytest.raises(ValueError):
        ring.push(b"x" * (1 << 13))
    ring.destroy()


def test_shmring_cross_process():
    ring = nat.ShmRing(capacity=1 << 14)
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=ring_producer, args=(ring.name,))
    p.start()
    out = []
    try:
        while True:
            m = ring.pop(timeout=WAIT_S)
            if m == b"__END__":
                break
            out.append(m.decode())
        p.join(timeout=WAIT_S)
        assert p.exitcode == 0
    finally:
        if p.is_alive():
            p.kill()
        ring.destroy()
    assert out == [f"msg-{i}" for i in range(100)]


# -- HostPool ----------------------------------------------------------------

def test_hostpool_stats_and_reuse():
    pool = nat.HostPool()
    a = pool.alloc((1024,), np.float32)  # 4096 B bucket
    a[:] = 1.0
    s1 = pool.stats()
    assert s1["current"] >= 4096 and s1["alloc_count"] == 1
    pool.free(a)
    assert pool.stats()["current"] == 0
    b = pool.alloc((1024,), np.float32)  # must come from the free list
    s2 = pool.stats()
    assert s2["reserved"] == s1["reserved"]  # no new system allocation
    assert s2["peak"] == s1["peak"]
    pool.free(b)
    pool.trim()
    assert pool.stats()["reserved"] == 0
    jpool = jnat.HostPool()
    ja = jpool.alloc((1024,), np.float32)
    assert {k: v for k, v in jpool.stats().items()} == s1
    jpool.free(ja)


# -- the shared-memory DataLoader --------------------------------------------

def test_shm_loader_yields_jax_batches_over_the_ring():
    kw = dict(batch_size=5, num_workers=2, use_shared_memory=True)
    dl = tio.DataLoader(Squares(), **kw)
    got = list(dl)
    assert dl.transport == {"main": 0, "workers": 0, "shm_ring": 8}
    want = list(JaxLoader(Squares(), **kw))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"x", "f"}
        assert isinstance(g["x"], torch.Tensor)
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))
        np.testing.assert_array_equal(g["f"].numpy(), np.asarray(w["f"]))
    plain = list(tio.DataLoader(Squares(), batch_size=5))
    for g, p in zip(got, plain):
        assert torch.equal(g["x"], p["x"]) and torch.equal(g["f"], p["f"])


def test_shm_loader_choice_follows_jax(monkeypatch):
    """The ring only with use_shared_memory, workers and the library;
    else JAX's worker pool (or the main process without workers)."""
    plain = tio.DataLoader(Squares(), batch_size=10, num_workers=2)
    assert len(list(plain)) == 4
    assert plain.transport == {"main": 0, "workers": 4, "shm_ring": 0}
    alone = tio.DataLoader(Squares(), batch_size=10, use_shared_memory=True)
    assert len(list(alone)) == 4 and alone.transport["main"] == 4
    monkeypatch.setattr(nat, "is_available", lambda: False)
    off = tio.DataLoader(Squares(), batch_size=10, num_workers=2,
                         use_shared_memory=True)
    assert len(list(off)) == 4
    assert off.transport == {"main": 0, "workers": 4, "shm_ring": 0}
