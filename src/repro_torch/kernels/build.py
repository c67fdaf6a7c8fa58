"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
libraries go to ``build/kernels/`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the sources,
so an edited source never loads a stale library.  ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them; a failed build
raises with nvcc's output.  Each build's compiler log (``-Xptxas -v``:
registers, shared memory, spills) is kept beside its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               _ROOT / "build" / "kernels"))


def kernel_names():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        cand = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found: building repro_torch's kernels "
                           "needs the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands: named by a hash of
    its source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once.  Returns the seconds each build took (0.0 for a
    library already built)."""
    names = list(names) if names is not None else kernel_names()
    started, secs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (out.parent / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)        # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_log(name: str) -> str:
    p = build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
