"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``, with the
shared headers ``ops/csrc/*.cuh``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds, not minutes. Libraries land under
``build/torch_kernels/`` at the repository root, named by a digest of
the source and the flags, and are built at first use: importing this
module compiles nothing, so the CPU tests (no ``nvcc``) import it
freely. A built library is reused by later processes until the source
changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_int = ctypes.c_int
_float = ctypes.c_float
_i64p = ctypes.POINTER(ctypes.c_longlong)
_ll = ctypes.c_longlong
_ull = ctypes.c_ulonglong
_intp = ctypes.POINTER(ctypes.c_int)

# C signatures of the exported entry points, per source file.
SIGNATURES = {
    "decode_attention": {
        "bs_paged_decode_attention": (
            [_int] + [_vp] * 8 + [_int] * 9 + [_float, _vp], _int),
        "bs_paged_decode_plan": ([_int] * 5 + [_intp], _int),
        "bs_dense_decode_attention_int8": (
            [_int] + [_vp] * 7 + [_int] * 7 + [_float, _vp], _int),
        "bs_dense_decode_plan": ([_int] * 4 + [_intp], _int),
        "bs_error_string": ([_int], ctypes.c_char_p),
    },
    "flash_attention": {
        "bs_flash_attention_fwd": (
            [_int] + [_vp] * 5 + [_i64p] + [_int] * 6 + [_float, _vp],
            _int),
        "bs_flash_attention_bwd": (
            [_int] + [_vp] * 9 + [_i64p] + [_int] * 6 + [_float, _vp],
            _int),
        "bs_flash_attention_smem": ([_int, _i64p], _int),
        "bs_error_string": ([_int], ctypes.c_char_p),
    },
    "chunked_loss": {
        "bs_xent_fwd": ([_int] + [_vp] * 7 + [_int] * 5 + [_vp], _int),
        "bs_xent_bwd": ([_int] + [_vp] * 13 + [_int] * 6 + [_vp], _int),
        "bs_error_string": ([_int], ctypes.c_char_p),
    },
    "fused_norm": {
        "bs_rmsnorm_matmul": ([_int] + [_vp] * 5 + [_int] * 4 + [_float, _vp],
                              _int),
        "bs_error_string": ([_int], ctypes.c_char_p),
    },
    "quantization": {
        "bs_quantize_int8": ([_int] + [_vp] * 4 + [_int] * 3 + [_vp], _int),
        "bs_int8_matmul": ([_int] + [_vp] * 5 + [_int] * 3 + [_vp], _int),
        "bs_row_absmax": ([_int] + [_vp] * 2 + [_int] * 3 + [_vp], _int),
        "bs_quantize_scaled": ([_int] + [_vp] * 4 + [_int] * 3 + [_vp],
                               _int),
        "bs_error_string": ([_int], ctypes.c_char_p),
    },
    "ring_collectives": {
        "bs_ring_alloc": ([_int, _ll, ctypes.POINTER(_vp)], _int),
        "bs_ring_free": ([_int, _vp], _int),
        "bs_ring_export": ([_int, _vp, _vp], _int),
        "bs_ring_import": ([_int, _vp, ctypes.POINTER(_vp)], _int),
        "bs_ring_close": ([_int, _vp], _int),
        "bs_ring_flag_alloc": ([_int, ctypes.POINTER(_intp)], _int),
        "bs_ring_flag_free": ([_intp], _int),
        "bs_ring_copy": (
            [_int, _int] + [_vp] * 6 + [_ll, _int, _int, _vp, _ull, _vp,
                                        _ull, _intp, _vp, _int, _vp], _int),
        "bs_virtual_all_gather": (
            [_int] + [_vp] * 2 + [_ll] + [_int] * 3 + [_vp], _int),
        "bs_virtual_gather_tile_units": ([], _ll),
        "bs_virtual_reduce_scatter": (
            [_int] + [_vp] * 2 + [_ll] + [_int] * 4 + [_vp], _int),
        "bs_virtual_reduce_tile_units": ([_int, _int], _ll),
        "bs_stream_mem_ops": ([_int, _intp], _int),
        "bs_ring_stream_create": ([_int, ctypes.POINTER(_vp)], _int),
        "bs_ring_stream_destroy": ([_int, _vp], _int),
        "bs_stream_wait": ([_int, _vp, _ull, _vp], _int),
        "bs_stream_write": ([_int, _vp, _ull, _vp], _int),
        "bs_ring_spin_wait": ([_int, _vp, _ull, _intp, _ll, _vp, _vp], _int),
        "bs_error_string": ([_int], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the "
                       "port's CUDA kernels are built on the GPU host")


def library_path(name: str) -> pathlib.Path:
    source = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def compile_source(source: pathlib.Path, target: pathlib.Path) -> float:
    """nvcc ``source`` into the shared library ``target``. Returns the
    seconds spent. The compiler's output (including ``-Xptxas -v``
    register and shared-memory reports) is kept beside the library as
    ``.log``."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(source)]
    started = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          check=False)
    seconds = time.perf_counter() - started
    target.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr,
        encoding="utf-8")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builders agree
    return seconds


def build(name: str, force: bool = False) -> tuple[pathlib.Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library already exists (or
    ``force``). Returns (library path, seconds spent compiling; 0.0 when
    reused)."""
    target = library_path(name)
    if target.exists() and not force:
        return target, 0.0
    return target, compile_source(CSRC / f"{name}.cu", target)


def load(path: pathlib.Path, name: str) -> ctypes.CDLL:
    """Load a library built from ``csrc/<name>.cu`` (or a copy of it)
    with argtypes/restype declared for every entry point it exports (an
    older build may lack a newer one; calling that raises)."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def library(name: str = "decode_attention") -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = load(build(name)[0], name)
        return lib


def check(rc: int, what: str, lib: Optional[ctypes.CDLL] = None) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        lib = lib or library()
        msg = lib.bs_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
