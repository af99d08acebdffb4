"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file becomes one ``.so`` with a plain C interface, built
by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``. The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is loaded from ``build/``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# No --use_fast_math: sqrtf must round as IEEE requires (-prec-sqrt=true is
# the default without it, and stated here so that no later flag drops it),
# and -fmad=false keeps nvcc from contracting a multiply and an add into one
# FMA anywhere the source did not ask for it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-prec-sqrt=true", "-fmad=false", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels are built from csrc/ at first use"
        )
    return str(candidate)


def library_path(name: str) -> Path:
    """Where ``csrc/{name}.cu`` builds to, keyed on its source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills for each kernel) from the build of ``csrc/{name}.cu``, or ``""``
    when the library was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    """Starts ``nvcc`` on ``csrc/{name}.cu`` unless its library exists;
    returns ``(process, output, temporary output)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, out, tmp


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build(names: Iterable[str]) -> None:
    """Builds every named source that is not built yet, one ``nvcc`` per
    source, all started together."""
    names: List[str] = list(names)
    procs = {name: _start(name) for name in names}
    for name in names:
        _finish(name, procs[name])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
