"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface, under ``_build/`` in the package (listed in
``.gitignore``), named by a hash of the sources and flags so an edited
source rebuilds. Nothing is built when a module is imported: the CPU tests
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Each entry point: (source in csrc/ without ".cu", C symbol, argtypes).
# A source may hold several entry points (a forward and its backward).
SIGNATURES = {
    "window_channel_attention": (
        "window_channel_attention", "window_channel_attention_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P]),
    "packed_window_channel_attention": (
        "window_channel_attention", "packed_window_channel_attention_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P]),
    "window_channel_attention_stage": (
        "window_attention_stages", "window_channel_attention_stage_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "window_relayout": (
        "window_relayout", "window_relayout_launch",
        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fused_structural_block": (
        "fused_structural_block", "fused_structural_block_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P]),
    "fused_structural_block_pair": (
        "fused_structural_block_pair", "fused_structural_block_pair_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "fused_structural_block_stream": (
        "fused_structural_block_stream", "fused_structural_block_stream_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P]),
    "window_attention_train_fwd": (
        "window_attention_train", "window_attention_train_fwd_launch",
        [_P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "window_attention_train_bwd": (
        "window_attention_train", "window_attention_train_bwd_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "window_mhsa_train_fwd": (
        "window_mhsa_train", "window_mhsa_train_fwd_launch",
        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "window_mhsa_train_bwd": (
        "window_mhsa_train", "window_mhsa_train_bwd_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "int8_conv": (
        "int8_conv", "int8_conv_launch",
        [_P, _P, _P, _P, _P, _P] + [_I] * 19 + [_P]),
}
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

_lock = threading.Lock()
_loaded: dict = {}  # entry point name -> ctypes function
_libs: dict = {}    # source name -> ctypes.CDLL


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels are built from csrc/ with nvcc")
    return path


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [os.path.join(CSRC, h) for h in headers]


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile source ``csrc/<name>.cu`` unless its hashed library exists;
    returns the library path. Raises with nvcc's output when compilation
    fails."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def build_all(names=SOURCES) -> dict:
    """Build several sources at once, one nvcc process each, all started
    together; returns {source: seconds it took}. Raises on the first
    failure after every build has ended."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def kernel(name: str):
    """The ctypes function of entry point ``name``, building its source on
    first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            source, symbol, argtypes = SIGNATURES[name]
            lib = _libs.get(source)
            if lib is None:
                lib = _libs[source] = ctypes.CDLL(build(source))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
