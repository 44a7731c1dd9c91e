"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, all compilers started together, and the
libraries are loaded with ``ctypes``.  The build happens at first use, from
the sources in the checkout, into ``src/repro_torch/_build/`` (listed in
``.gitignore``); a library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Each library's ``ptxas`` report (registers, spills) is kept beside it and
read back on reuse.  Nothing here runs at import time.
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
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

KERNEL_SOURCES = {
    "sparse_decode_attention": "sparse_decode_attention.cu",
    "block_score": "block_score.cu",
    "gather_blocks": "gather_blocks.cu",
    "scatter_blocks": "scatter_blocks.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# exported launch function of each library and its C signature
_SIGNATURES = {
    "sparse_decode_attention": (
        "launch_sparse_decode_attention",
        [_P] * 7 + [_I] * 8 + [_F, _P]),
    "block_score": ("launch_block_score", [_P, _P, _P] + [_I] * 5 + [_P]),
    "gather_blocks": ("launch_gather_blocks_hkv",
                      [_P, _L, _I, _P, _P, _I, _I, _I, _L, _P]),
    "scatter_blocks": ("launch_scatter_blocks_hkv",
                       [_I, _P, _P, _P, _P, _L, _L, _L] + [_I] * 5
                       + [_P]),
}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in (CSRC_DIR / "common.cuh", CSRC_DIR / KERNEL_SOURCES[name]):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


class KernelLibraries:
    """The four kernel libraries, built once per process (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: Dict[str, ctypes._CFuncPtr] = {}
        self.build_seconds: Optional[float] = None
        self.ptxas_info: Dict[str, str] = {}
        self.rebuilt: List[str] = []

    def build(self) -> float:
        """Compile every stale library (one nvcc process per source, all
        running at once), load all four, and return the seconds taken.
        ``ptxas_info`` holds each library's ptxas report and ``rebuilt``
        the names compiled by this call."""
        with self._lock:
            if self._fns:
                return 0.0
            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = nvcc_path()
            procs: List = []
            for name, src in KERNEL_SOURCES.items():
                out = _lib_path(name)
                if out.exists():
                    report = out.with_suffix(".ptxas.txt")
                    self.ptxas_info[name] = (report.read_text()
                                             if report.exists() else "")
                    continue
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = ([nvcc] + NVCC_FLAGS
                       + ["-I", str(CSRC_DIR), "-o", str(tmp),
                          str(CSRC_DIR / src)])
                procs.append((name, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            errors = []
            for name, out, tmp, proc in procs:
                stdout, stderr = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                                  f"{stdout}{stderr}")
                    continue
                self.ptxas_info[name] = stderr
                out.with_suffix(".ptxas.txt").write_text(stderr)
                os.replace(tmp, out)
                self.rebuilt.append(name)
            if errors:
                raise RuntimeError("kernel build failed:\n" +
                                   "\n".join(errors))
            for name in KERNEL_SOURCES:
                lib = ctypes.CDLL(str(_lib_path(name)))
                sym, argtypes = _SIGNATURES[name]
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._fns[name] = fn
            self.build_seconds = time.perf_counter() - t0
            return self.build_seconds

    def fn(self, name: str):
        if not self._fns:
            self.build()
        return self._fns[name]


LIBS = KernelLibraries()
