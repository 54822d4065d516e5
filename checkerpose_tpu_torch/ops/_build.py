"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `checkerpose_tpu_torch/csrc/` compiles into one shared
library with a plain C interface, in `build/` at the repo root, named by a
hash of its source and flags, so an edited source rebuilds and an unchanged
one is reused. Builds run at first use (or all at once, in parallel, through
`build()`); ptxas's register and shared-memory report is kept beside each
library. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build"
SOURCES = {"edgeconv": _PKG / "csrc" / "edgeconv.cu",
           "edgeconv_tc": _PKG / "csrc" / "edgeconv_tc.cu",
           "ransac": _PKG / "csrc" / "ransac.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def ptxas_report(name: str) -> str:
    """What `-Xptxas -v` printed when the library was built."""
    report = library_path(name).with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library, one nvcc per source, all at once."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built if needed; loaded once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
