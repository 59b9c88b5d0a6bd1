"""The host rates a checkpoint depends on, measured on this machine.

``python -m paddle_tpu_torch.tools.io_probe [--dir DIR] [--gib N]
[--device cpu]`` prints, as one JSON line: the disk's write rate with an
fsync a file (``--gib`` GiB as 1 GiB files on 4 threads, then read back
and deleted), sha256 on one thread and on 8, and on the card (the
default; ``--device cpu`` leaves these out) the rate of allocating
pinned host memory and of copying between it and the card.
``CheckpointManager`` saves at about the write rate (the writer hashes
what it writes, on 4 threads) and verifies at the sha256 rate; the
async snapshot costs the pinned allocation once and the copy every
save.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device

GIB = 1 << 30


def _write(path: str, buf) -> None:
    with open(path, "wb") as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())


def probe(directory: str, gib: int = 8, device=None) -> dict:
    dev = resolve_device(device)
    out = {}
    host = np.ones(GIB, np.uint8)
    t0 = time.perf_counter()
    hashlib.sha256(memoryview(host)).hexdigest()
    out["sha256_1_thread_gb_s"] = GIB / 1e9 / (time.perf_counter() - t0)
    half = GIB // 8
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda i: hashlib.sha256(
            memoryview(host[i * half:(i + 1) * half])).hexdigest(),
            range(8)))
    out["sha256_8_threads_gb_s"] = GIB / 1e9 / (time.perf_counter() - t0)
    d = tempfile.mkdtemp(prefix="io_probe_", dir=directory)
    try:
        paths = [os.path.join(d, f"f{i}") for i in range(gib)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda p: _write(p, memoryview(host)), paths))
        out["write_fsync_4_threads_gb_s"] = (gib * GIB / 1e9
                                             / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for p in paths:
            with open(p, "rb") as f:
                while f.read(64 << 20):
                    pass
        out["read_gb_s"] = gib * GIB / 1e9 / (time.perf_counter() - t0)
    finally:
        for name in os.listdir(d):
            os.remove(os.path.join(d, name))
        os.rmdir(d)
    if dev.type == "cuda":
        n = 4 * GIB
        t0 = time.perf_counter()
        pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        out["pinned_alloc_gb_s"] = n / 1e9 / (time.perf_counter() - t0)
        card = torch.ones(n, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned.copy_(card, non_blocking=True)
        torch.cuda.synchronize()
        out["card_to_pinned_gb_s"] = n / 1e9 / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        card.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        out["pinned_to_card_gb_s"] = n / 1e9 / (time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=".",
                   help="where the test files are written (and removed)")
    p.add_argument("--gib", type=int, default=8,
                   help="GiB written (1 GiB a file)")
    p.add_argument("--device", default=None,
                   help="the card by default; cpu: host rates only")
    args = p.parse_args(argv)
    print(json.dumps(probe(args.dir, args.gib, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
