"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point (no
PyTorch headers), compiled for Hopper into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so <src>

The library name carries a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded from ``build/repro_torch/``
(listed in ``.gitignore``). ``--use_fast_math`` is never passed: the
quantizer and dequantizer depend on IEEE division and multiplication.
Nothing is compiled when a module is imported; :func:`load` builds on a
kernel's first launch and :func:`build_all` starts every ``nvcc`` at
once. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_longlong
# kernel name -> (source, C entry point, argtypes)
KERNELS: Dict[str, tuple] = {
    "fused_precodec": (
        _PKG / "fused" / "csrc" / "fused_precodec.cu",
        "fused_precodec_launch",
        [_P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "quantize": (
        _PKG / "quantize" / "csrc" / "quantize.cu",
        "quantize_launch",
        [_P, _P, _P, _I, _P],
    ),
    "dequantize": (
        _PKG / "quantize" / "csrc" / "dequantize.cu",
        "dequantize_launch",
        [_P, _P, _P, _I, _P],
    ),
    "checksum": (
        _PKG / "checksum" / "csrc" / "checksum.cu",
        "checksum_launch",
        [_P, _P, _I, _P],
    ),
    "xor_delta": (
        _PKG / "delta" / "csrc" / "delta.cu",
        "xor_delta_launch",
        [_P, _P, _P, _P, _I, _P],
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS[name][0])]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Build every kernel that is not built yet, all ``nvcc`` processes
    started together. Returns ``{name: library path}``."""
    with _lock:
        procs = {
            n: _start(n) for n in KERNELS if not library_path(n).exists()
        }
        errors: List[str] = []
        for n, p in procs.items():
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: str(library_path(n)) for n in KERNELS}


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for ``name`` (registers, spills),
    or "" when the library was built by an earlier process."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str):
    """The C entry point of kernel ``name``, built on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is not None:
            return fn
        path = library_path(name)
        if not path.exists():
            _finish(name, _start(name))
        src, sym, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
        return fn
