"""Build and load the port's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes).  Libraries land in
``paddle_tpu_torch/csrc/_build/`` at first use, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  ``build_all`` starts one ``nvcc`` per source, all at once.

``note_launch`` is the kernels' launch count: a wrapper calls it once a
launch.  Inside a CUDA graph capture nothing runs, so the launch goes into
the capture's tally instead, which the graph adds on every replay
(``jit/programs.py``).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

# library name -> its source file under csrc/
SOURCES = {"ragged_paged_attention": "ragged_paged_attention.cu",
           "paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "fused": "fused.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
_capture_tally: Dict[object, int] = {}


def note_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``,
    or, while this thread's stream is being captured into a CUDA graph
    (where the kernel is recorded, not run), in the capture's tally."""
    if (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        _capture_tally[wrapper] = _capture_tally.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


def take_capture_tally() -> Dict[object, int]:
    """The launches tallied since the last call, {wrapper: count}; clears
    the tally."""
    out = dict(_capture_tally)
    _capture_tally.clear()
    return out


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                           "CUDA_HOME to build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        digest.update(hdr.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, str]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: compiler output}`` for
    the libraries built by this call (with ``verbose``, ptxas's register
    and shared-memory report per kernel).  Raises if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose
                                           else []),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed (once a process)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
