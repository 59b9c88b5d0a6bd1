"""Build and load the port's CUDA kernels.

Every ``.cu`` file under ``paddle_tpu_torch/csrc/`` is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` into one shared
library with a plain C interface, loaded with ``ctypes``. The sources
are compiled to objects in parallel (one ``nvcc`` per file, all started
together), then linked by one ``nvcc -shared`` call. The library lives
under ``build/torch_kernels/`` at the repository root and its file name
carries a hash of the sources and flags, so an edited source is rebuilt
at its first use and an unchanged one is loaded as it is.

Nothing here runs at import: the first kernel launch builds and loads.
Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.

Each wrapper counts its launches in :data:`LAUNCHES`, adding one where
it launches its kernel and nowhere else, so a run can show which kernels
its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"rms_norm": 0, "rms_norm_bwd": 0,
                            "fused_rope": 0, "flash_fwd": 0,
                            "flash_bwd": 0,
                            "paged_decode": 0, "paged_decode_int8": 0,
                            "vocab_ce_fwd": 0, "vocab_ce_dlog": 0,
                            "vocab_ce_dh": 0, "vocab_ce_dw": 0,
                            "int8_matmul": 0, "grouped_matmul": 0,
                            "grouped_matmul_dw": 0}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG: Dict[str, object] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpaddle_tpu_torch_kernels-{_digest()}.so"


def build() -> Path:
    """Compile the sources unless a library of their hash exists; returns
    its path. Raises with nvcc's output when a compile fails."""
    out = library_path()
    if out.exists():
        BUILD_LOG.update(seconds=0.0, cached=True, path=str(out))
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stage = BUILD_DIR / f"stage-{os.getpid()}-{time.time_ns()}"
    stage.mkdir()
    t0 = time.perf_counter()
    try:
        procs = []
        for src in sources():
            obj = stage / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs[src.name] = text
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        tmp = stage / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o",
             str(tmp),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, cached=False,
                     path=str(out), ptxas=logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        _LIB = _declare(ctypes.CDLL(str(build())))
    return _LIB


def _declare(so: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong, ctypes.c_uint
    so.pt_rms_norm_fwd.argtypes = [P, P, P, P, I, I, F, I, I, I, P]
    so.pt_rms_norm_bwd.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
    so.pt_fused_rope.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I,
                                 LL, LL, LL, LL, LL, LL, I, I, P]
    so.pt_paged_decode.argtypes = [P] * 8 + [I] * 7 + [F, I, P]
    so.pt_int8_matmul.argtypes = [P] * 4 + [I] * 4 + [P]
    so.pt_grouped_matmul.argtypes = [P] * 4 + [I] * 8 + [P]
    so.pt_grouped_matmul_dw.argtypes = [P] * 4 + [I] * 7 + [P]
    flash = [P] * 13 + [I] * 6 + [LL] * 9 + [F, I, I, U, U, F, F, I, P]
    so.pt_vocab_ce_splits.argtypes = [I, I, I]
    so.pt_vocab_ce_fwd.argtypes = [P] * 4 + [I] * 6 + [P]
    so.pt_vocab_ce_dlog.argtypes = [P] * 7 + [I] * 8 + [P]
    so.pt_vocab_ce_dh.argtypes = [P] * 4 + [I] * 10 + [P]
    so.pt_vocab_ce_dw.argtypes = [P] * 3 + [I] * 8 + [P]
    fns = [so.pt_rms_norm_fwd, so.pt_rms_norm_bwd, so.pt_fused_rope,
           so.pt_paged_decode, so.pt_int8_matmul, so.pt_grouped_matmul,
           so.pt_grouped_matmul_dw,
           so.pt_vocab_ce_splits, so.pt_vocab_ce_fwd, so.pt_vocab_ce_dlog,
           so.pt_vocab_ce_dh, so.pt_vocab_ce_dw]
    for name in ("pt_flash_fwd", "pt_flash_bwd_dq", "pt_flash_bwd_dkv",
                 "pt_flash_bwd"):
        fn = getattr(so, name)
        fn.argtypes = flash
        fns.append(fn)
    for fn in fns:
        fn.restype = ctypes.c_int
    return so


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def dtype_code(dtype) -> int:
    """The C side's element type code: 0 float32, 1 bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["build", "lib", "check", "LAUNCHES", "count_launch",
           "reset_launches", "BUILD_DIR", "CSRC", "dtype_code", "stream_ptr"]
