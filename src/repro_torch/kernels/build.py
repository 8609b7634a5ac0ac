"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with a plain C interface; the objects are linked into ONE
shared library under ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``) and loaded with ``ctypes``.  The library's file
name carries a hash of the sources and flags, so an edited source
rebuilds at the next first use and an unchanged tree reuses the library.
Nothing is built at import time: the first kernel launch builds.

A C entry returns ``cudaGetLastError()`` after its launch; the Python
wrappers raise when it is not 0.  ``LAUNCHES`` counts launches per
kernel: each wrapper adds one exactly where it launches its kernel, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

SOURCES = ("paged_attention.cu", "verify_accept.cu", "paged_gather.cu")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

# launches per kernel name, added to by the wrappers in kernels/*.py
LAUNCHES: Dict[str, int] = {"paged_attention": 0,
                            "verify_accept_batched": 0,
                            "paged_gather": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  Reuses an existing library built from identical sources."""
    so = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if so.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [cc, *CFLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                   "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, objs = [], []
        for name, obj, p in procs:
            out, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}{err}")
            logs.append(f"--- {name}\n{err}")
            objs.append(obj)
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run([cc, *ARCH, "-shared", *objs, "-o", tmp_so],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, so)
    BUILD_INFO["seconds"] = time.time() - t0
    BUILD_INFO["ptxas"] = "".join(logs)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.repro_paged_attention.argtypes = (
            [P] * 7 + [I] * 9 + [F, F, I, P])
        L.repro_paged_attention.restype = I
        L.repro_paged_attention_smem.argtypes = [I, I, I]
        L.repro_paged_attention_smem.restype = ctypes.c_size_t
        L.repro_verify_accept_batched.argtypes = [P] * 10 + [I] * 3 + [P]
        L.repro_verify_accept_batched.restype = I
        L.repro_paged_gather.argtypes = [P] * 3 + [I] * 4 + [P]
        L.repro_paged_gather.restype = I
        _lib = L
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
