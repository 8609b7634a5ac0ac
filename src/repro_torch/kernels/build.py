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

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

# the flash kernels' ragged load path, and the flash backward's f32
# instances, build as objects of their own (``*_ragged.cu`` and
# ``*_f32*.cu`` include their source), compiled beside the rest
SOURCES = ("flash_attention_bwd.cu", "flash_attention_bwd_ragged.cu",
           "flash_attention_bwd_f32.cu", "flash_attention_bwd_f32_ragged.cu",
           "flash_attention.cu", "flash_attention_ragged.cu",
           "paged_attention.cu", "branch_attention.cu", "ssm_scan.cu",
           "ssm_scan_bwd.cu", "verify_accept.cu", "paged_gather.cu")
HEADERS = ("decode_attention.cuh", "ssm_scan_step.cuh")  # hashed too
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

# launches per kernel name, added to by the wrappers in kernels/*.py
LAUNCHES: Dict[str, int] = {"paged_attention": 0,
                            "verify_accept_batched": 0,
                            "paged_gather": 0,
                            "flash_attention": 0,
                            "ssm_scan": 0,
                            "ssm_scan_ring": 0,
                            "branch_decode_attention": 0,
                            "verify_accept": 0,
                            "flash_attention_bwd": 0,
                            "ssm_scan_bwd": 0}

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


def _digest(sources=SOURCES, defines=()) -> str:
    h = hashlib.sha256(" ".join(CFLAGS + list(defines)).encode())
    for name in tuple(sources) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(sources=SOURCES, defines=()) -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  Reuses an existing library built from identical sources.
    ``defines`` (``-D`` flags) build a variant, as ``chip_smoke.py
    --probe`` does to time the attention tile loop phase by phase."""
    so = BUILD_DIR / f"libreprotorch_{_digest(sources, defines)}.so"
    if so.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def compile_one(name):
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [cc, *CFLAGS, *defines, "-Xptxas", "-v", "-c",
                   str(CSRC / name),
                   "-o", obj]
            p = subprocess.run(cmd, capture_output=True, text=True)
            return name, obj, p, time.time() - t0

        with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
            done = list(ex.map(compile_one, sources))
        logs, objs = [], []
        for name, obj, p, _ in done:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{p.stdout}"
                                   f"{p.stderr}")
            logs.append(f"--- {name}\n{p.stderr}")
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
    # each source's nvcc, from the start of the build to its end
    BUILD_INFO["per_source"] = {name: sec for name, _, _, sec in done}
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def _signatures() -> Dict[str, tuple]:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    LL = ctypes.c_longlong
    return {  # entry: (argtypes, restype)
        "repro_paged_attention": ([P] * 7 + [I] * 12 + [F, F, I, P], I),
        "repro_verify_accept_batched": ([P] * 10 + [I] * 4 + [P], I),
        "repro_paged_gather": ([P] * 3 + [I] * 4 + [P], I),
        "repro_flash_attention": ([P] * 7 + [I] * 13 + [F, F, I, P], I),
        "repro_ssm_scan": ([P] * 10 + [I] * 5 + [P], I),
        "repro_ssm_scan_ring": ([P] * 10 + [I] * 7 + [P], I),
        "repro_ssm_scan_chunks": ([P] * 10 + [I] * 5 + [P], I),
        "repro_ssm_scan_chunk": ([], I),
        "repro_branch_attention": ([P] * 9 + [I] * 11 + [F, F, I, P], I),
        "repro_verify_accept": ([P] * 9 + [I] * 4 + [P], I),
        "repro_flash_attention_bwd": ([P] * 12 + [LL, P, LL] + [I] * 10
                                      + [F, F, I, P], I),
        "repro_ssm_scan_bwd": ([P] * 17 + [I] * 5 + [P], I),
        "repro_ssm_scan_bwd_scratch": ([I] * 4, LL),
    }


def bind(L: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' signatures on a loaded library (a variant built
    from some of the sources lacks the others' entries)."""
    for name, (args, res) in _signatures().items():
        if hasattr(L, name):
            fn = getattr(L, name)
            fn.argtypes, fn.restype = args, res
    return L


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
