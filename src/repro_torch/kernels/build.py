"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, all compilers started together, and the
libraries are loaded with ``ctypes``.  The build happens at first use, from
the sources in the checkout, into ``src/repro_torch/_build/`` (listed in
``.gitignore``); a library's file name carries a hash of its source, every
``csrc/*.cuh`` header and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.
Each library's ``ptxas`` report (registers, spills) is kept beside it and
read back on reuse.  Beside them, FAULT_VARIANTS: builds with a planted
fault, for the checks that must reject it.  Nothing here runs at import
time.
"""
from __future__ import annotations

import contextlib
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
    "flash_prefill": "flash_prefill.cu",
    "flash_prefill_bwd": "flash_prefill_bwd.cu",
    "quant_blocks": "quant_blocks.cu",
    "selective_scan": "selective_scan.cu",
    "selective_scan_bwd": "selective_scan_bwd.cu",
    "wkv6": "wkv6.cu",
    "wkv6_bwd": "wkv6_bwd.cu",
}
# builds of a source with a -D switch that plants a fault its checks must
# reject (chip_smoke.py's train phase and the gpu tests use them through
# ``LIBS.planted``; the port never does): name -> (library, switch)
FAULT_VARIANTS = {
    "wkv6_bwd:no_aend": ("wkv6_bwd", "WKV_BWD_FAULT_NO_AEND"),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# exported functions: name -> (library, C symbol, C signature[, return
# type, int by default])
_SIGNATURES = {
    "sparse_decode_attention": (
        "sparse_decode_attention", "launch_sparse_decode_attention",
        [_P] * 9 + [_I] * 9 + [_F, _P]),
    "sparse_decode_attention:partial": (
        "sparse_decode_attention", "launch_sparse_decode_attention_partial",
        [_P] * 10 + [_I] * 10 + [_F, _P]),
    "sparse_decode_attention_smem": (
        "sparse_decode_attention", "sparse_decode_attention_smem_bytes",
        [_I] * 6),
    "block_score": ("block_score", "launch_block_score",
                    [_P, _P, _P] + [_I] * 5 + [_P]),
    "score_select": ("block_score", "launch_score_select",
                     [_P] * 5 + [_I] * 11 + [_P]),
    "gather_blocks_hkv": ("gather_blocks", "launch_gather_blocks_hkv",
                          [_P, _L, _I, _P, _P, _I, _I, _I, _L, _P]),
    "gather_blocks": ("gather_blocks", "launch_gather_blocks",
                      [_P, _L, _I, _P, _P, _I, _I, _L, _P]),
    "scatter_blocks_hkv": ("scatter_blocks", "launch_scatter_blocks_hkv",
                           [_I, _P, _P, _P, _P, _L, _L, _L] + [_I] * 5
                           + [_P]),
    "zero_blocks_hkv": ("scatter_blocks", "launch_zero_blocks_hkv",
                        [_P, _P, _I, _I, _L, _L, _L, _L, _P]),
    "write_blocks_hkv": ("scatter_blocks", "launch_write_blocks_hkv",
                         [_P, _P, _P, _L, _I, _L, _L, _I, _I, _I, _L, _P]),
    "scatter_blocks": ("scatter_blocks", "launch_scatter_blocks",
                       [_P, _P, _P, _L, _I, _I, _I, _L, _P]),
    "flash_prefill": ("flash_prefill", "launch_flash_prefill",
                      [_P] * 5 + [_I] * 9 + [_F, _P]),
    "flash_prefill_bwd": ("flash_prefill_bwd", "launch_flash_prefill_bwd",
                          [_P] * 7 + [_L] + [_P] * 3 + [_I] * 8 + [_F, _P]),
    "flash_prefill_bwd_ws": ("flash_prefill_bwd",
                             "flash_prefill_bwd_ws_floats", [_I] * 7, _L),
    "quantize_blocks": ("quant_blocks", "launch_quantize_blocks",
                        [_I, _P, _P, _P, _I, _I, _P]),
    "dequantize_blocks": ("quant_blocks", "launch_dequantize_blocks",
                          [_P, _P, _P, _I, _I, _P]),
    "dequantize_scatter_blocks": (
        "quant_blocks", "launch_dequantize_scatter_blocks",
        [_P] * 5 + [_L] * 3 + [_I] * 5 + [_P]),
    "quant_save_blocks": ("quant_blocks", "launch_quant_save_blocks",
                          [_P] + [_I] * 4 + [_P]),
    "host_device_address": ("quant_blocks", "host_device_address",
                            [_P, _P]),
    "selective_scan": ("selective_scan", "launch_selective_scan",
                       [_P] * 9 + [_I] * 4 + [_P]),
    "selective_scan:train": ("selective_scan", "launch_selective_scan_f32",
                             [_P] * 10 + [_I] * 4 + [_P]),
    "selective_scan_bwd": ("selective_scan_bwd", "launch_selective_scan_bwd",
                           [_P] * 17 + [_L] + [_I] * 4 + [_P]),
    "selective_scan_bwd_ws": ("selective_scan_bwd",
                              "selective_scan_bwd_ws_floats", [_I] * 3, _L),
    "wkv6": ("wkv6", "launch_wkv6", [_P] * 10 + [_I] * 5 + [_P]),
    "wkv6:train": ("wkv6", "launch_wkv6_f32", [_P] * 10 + [_I] * 5 + [_P]),
    "wkv6_bwd": ("wkv6_bwd", "launch_wkv6_bwd", [_P] * 17 + [_I] * 5 + [_P]),
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


def _lib_path(name: str, flag: str = "") -> Path:
    h = hashlib.sha1()
    for src in [KERNEL_SOURCES[name],
                *sorted(p.name for p in CSRC_DIR.glob("*.cuh"))]:
        h.update((CSRC_DIR / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS + ([f"-D{flag}"] if flag else [])).encode())
    tag = f"-{flag.lower()}" if flag else ""
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


# (library path, nvcc switches, name the report is kept under or None) of
# every build: the kernels' libraries, then the planted faults'
def _builds():
    for name in KERNEL_SOURCES:
        yield name, _lib_path(name), [], name
    for key, (lib, flag) in FAULT_VARIANTS.items():
        yield lib, _lib_path(lib, flag), [f"-D{flag}"], None


class KernelLibraries:
    """The kernel libraries, built once per process (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: Dict[str, ctypes._CFuncPtr] = {}
        self._planted: Dict[str, ctypes._CFuncPtr] = {}
        self.build_seconds: Optional[float] = None
        self.ptxas_info: Dict[str, str] = {}
        self.rebuilt: List[str] = []

    def build(self) -> float:
        """Compile every stale library (one nvcc process per source, all
        running at once), load them all, and return the seconds taken.
        ``ptxas_info`` holds each library's ptxas report and ``rebuilt``
        the names compiled by this call."""
        with self._lock:
            if self._fns:
                return 0.0
            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = nvcc_path()
            procs: List = []
            for name, out, flags, report_as in _builds():
                if out.exists():
                    report = out.with_suffix(".ptxas.txt")
                    if report_as:
                        self.ptxas_info[name] = (report.read_text()
                                                 if report.exists() else "")
                    continue
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = ([nvcc] + NVCC_FLAGS + flags
                       + ["-I", str(CSRC_DIR), "-o", str(tmp),
                          str(CSRC_DIR / KERNEL_SOURCES[name])])
                procs.append((name, out, tmp, report_as, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            errors = []
            for name, out, tmp, report_as, proc in procs:
                stdout, stderr = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{out.name}: nvcc exited "
                                  f"{proc.returncode}\n{stdout}{stderr}")
                    continue
                out.with_suffix(".ptxas.txt").write_text(stderr)
                os.replace(tmp, out)
                if report_as:
                    self.ptxas_info[name] = stderr
                    self.rebuilt.append(name)
            if errors:
                raise RuntimeError("kernel build failed:\n" +
                                   "\n".join(errors))
            libs = {name: ctypes.CDLL(str(_lib_path(name)))
                    for name in KERNEL_SOURCES}
            for name, (lib, sym, argtypes, *res) in _SIGNATURES.items():
                fn = getattr(libs[lib], sym)
                fn.argtypes = argtypes
                fn.restype = res[0] if res else ctypes.c_int
                self._fns[name] = fn
            for key, (lib, flag) in FAULT_VARIANTS.items():
                _, sym, argtypes = _SIGNATURES[lib][:3]
                fn = getattr(ctypes.CDLL(str(_lib_path(lib, flag))), sym)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                self._planted[key] = fn
            self.build_seconds = time.perf_counter() - t0
            return self.build_seconds

    def fn(self, name: str):
        if not self._fns:
            self.build()
        return self._fns[name]

    @contextlib.contextmanager
    def planted(self, key: str):
        """Within the block the wrapper of FAULT_VARIANTS[key]'s library
        launches the build with that fault planted."""
        lib = FAULT_VARIANTS[key][0]
        whole = self.fn(lib)
        self._fns[lib] = self._planted[key]
        try:
            yield
        finally:
            self._fns[lib] = whole


LIBS = KernelLibraries()
