"""Builds the package's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (raw pointers, sizes, the
stream) and becomes ``build/lib<name>_<hash>.so``, keyed on a hash of the
source and the compiler flags, at first use.  Nothing is built when the
package is imported.  A build or load failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("blobs", "scan", "areas", "qconv", "eval", "jpeg", "train")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "openglottal_tpu_torch cannot be built")


def _target(name: str, flags, src: Path | None = None) -> tuple[Path, Path]:
    src = src or CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str, extra_flags=(), src: Path | None = None):
    """Start nvcc for one source unless its library exists; returns
    (process | None, tmp path, final path)."""
    flags = (*NVCC_FLAGS, *extra_flags)
    src, out = _target(name, flags, src)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen([_nvcc(), *flags, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_build(name, proc, tmp, out) -> tuple[Path, str]:
    log = ""
    if proc is not None:
        raw, _ = proc.communicate()
        log = raw.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return out, log


def build_all(extra_flags=()) -> dict[str, str]:
    """Build every source, one nvcc process each, all started together, and
    load the libraries.  Returns the compiler's output per source (give
    ``extra_flags=("-Xptxas", "-v")`` for registers and shared memory)."""
    logs = {}
    with _lock:
        jobs = [(n, *_start_build(n, extra_flags)) for n in SOURCES
                if n not in _libs]
        for name, proc, tmp, out in jobs:
            path, logs[name] = _finish_build(name, proc, tmp, out)
            _libs[name] = ctypes.CDLL(str(path))
    return logs


def build_others(sources: dict[str, Path], extra_flags=()):
    """Build .cu files from outside the package (another checkout's kernels,
    to time them against this one's), one nvcc each, all started together, as
    ``build/lib<name>_<hash>.so``.  They are not what ``load`` returns.
    Returns {name: (library, compiler output)}."""
    jobs = [(n, *_start_build(n, extra_flags, Path(src)))
            for n, src in sources.items()]
    built = {}
    for name, proc, tmp, out in jobs:
        path, log = _finish_build(name, proc, tmp, out)
        built[name] = (ctypes.CDLL(str(path)), log)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first call)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_finish_build(name, *_start_build(name))[0]))
                _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
