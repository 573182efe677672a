"""Build the hand-written CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``_build/lib<name>-<hash>.so`` (the hash covers every source and header,
so an edited kernel is never served stale).  Nothing builds at import: the
first wrapper call builds, and :func:`build_all` starts one ``nvcc`` per
source at once.  Every C entry returns ``cudaGetLastError()``; :func:`check`
raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("wkv6_fwd", "joint_topk", "lstm_step", "fused_topk", "topk",
           "ffn", "multi_product")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_entries: dict = {}


class KernelError(RuntimeError):
    pass


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                      "are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                       + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest()}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns {name: seconds} for the libraries built by this call; writes
    each compiler log (``-Xptxas -v`` register/spill report included) to
    ``_build/<name>.log``.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log,
                       tmp, out)
    times, failed = {}, []
    for name, (proc, log, tmp, out) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        logs = "\n".join(
            open(os.path.join(BUILD_DIR, f"{n}.log")).read()[-4000:]
            for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{logs}")
    return times


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ``argtypes``
    and an int ``restype`` set once, at first use."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entries[name, symbol] = fn
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code}")


def check_device(what: str, ref, *tensors) -> None:
    """Raise unless every tensor lies on ``ref``'s device: a kernel handed a
    host pointer faults instead of failing cleanly."""
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{what}: tensors on {t.device} and "
                             f"{ref.device}; all must share one CUDA device")


def aligned16(t):
    """``t`` contiguous with a 16-byte-aligned start (TMA and 16-byte
    vector loads need it): a copy only for a view that starts mid-row."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    """0 for float32, 1 for bfloat16: the C entries' dtype argument."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise KernelError(f"kernels take float32 or bfloat16, not {dtype}")
