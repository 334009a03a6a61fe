"""Build and load the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each source in ``repro_torch/csrc/`` becomes one library, compiled at
first use for ``sm_90a`` into ``repro_torch/_build/`` (listed in
``.gitignore``) under a name that carries the hash of the source, of the
headers it includes from ``csrc/`` and of the flags, so an edited source
or header rebuilds and an unchanged one loads the library already built. ``build_all`` starts one ``nvcc`` per source at
once. A failed build raises with the compiler's output; nothing is ever
taken from outside the repository's own sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("pairwise_l2", "fused_topk", "quant_lb2", "lpgf_force",
           "flash_attention", "flash_attention_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points per library: name -> (argtypes, restype). Pointers and
# the stream are c_void_p (a bare int would cut a 64-bit pointer); a
# launch returns cudaGetLastError() as an int.
SIGNATURES: Dict[str, Dict[str, Tuple[List, object]]] = {
    "pairwise_l2": {
        "pairwise_sq_l2_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
    },
    "fused_topk": {
        "topk_l2_masked_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _P], _I),
        "topk_l2_masked_scratch_bytes": ([_I, _I, _I], _L),
        "topk_l2_splits": ([_I, _I, _I, _I], _I),
        "topk_l2_reg_k": ([], _I),
        "topk_l2_scratch_bytes": ([_I, _I, _I, _I], _L),
        "topk_l2_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        "topk_l2_merge_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
    },
    "quant_lb2": {
        "quant_lb2_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _P], _I),
    },
    "lpgf_force": {
        "lpgf_force_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                               _F, _P], _I),
    },
    "flash_attention": {
        "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _F, _L, _L, _L, _L, _L, _L, _L, _L,
                                    _L, _P], _I),
    },
    "flash_attention_wgmma": {
        "flash_attention_wgmma_launch": ([_P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _F, _L, _L, _L, _L, _L,
                                          _L, _L, _L, _L, _P], _I),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc on the machine with the "
                           "card")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def headers(name: str) -> List[str]:
    """The ``csrc/`` headers ``csrc/<name>.cu`` includes, directly or
    through another header, in the order first met."""
    found: List[str] = []
    todo = [f"{name}.cu"]
    while todo:
        with open(os.path.join(CSRC, todo.pop(0)), "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                inc = inc.decode()
                if inc not in found:
                    found.append(inc)
                    todo.append(inc)
    return found


def _target(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", *headers(name)):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built.
    Returns (name, target, process or None)."""
    so = _target(name)
    if os.path.exists(so):
        return name, so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, so, (proc, tmp)


def _finish(name: str, so: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    with open(f"{so}.log", "w") as f:
        f.write(out)
    os.replace(tmp, so)       # atomic: a concurrent loader sees all or none


def _load(name: str, so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _libs[name] = lib
    return lib


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all started
    together, and load them. Returns {name: compiler output} (the ptxas
    report of registers, shared memory and spills, kept beside each
    library when it was built)."""
    with _lock:
        jobs = [_start(n) for n in SOURCES if n not in _libs]
        for name, so, job in jobs:
            _finish(name, so, job)
            _load(name, so)
    logs = {}
    for name in SOURCES:
        logs[name] = ""
        if os.path.exists(f"{_target(name)}.log"):
            with open(f"{_target(name)}.log") as f:
                logs[name] = f.read()
    return logs


def spill_bytes(report: str) -> Dict[str, int]:
    """{kernel: spill bytes, stores and loads} from a ``ptxas -v`` report
    (``build_all``'s), by the mangled name of each entry function."""
    out: Dict[str, int] = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name] = int(m.group(1)) + int(m.group(2))
            name = None
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            n, so, job = _start(name)
            _finish(n, so, job)
            _load(n, so)
        return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
