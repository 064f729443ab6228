"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for ``sm_90a`` into a shared library under ``kernels/_build/`` (listed in
``.gitignore``) the first time it is used.  The library name carries a
digest of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  :func:`build_all` starts one ``nvcc``
per missing library and waits for all of them, so several kernels build
in parallel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# streaming multiprocessors of the card the flags target (H100 SXM), for
# the launch plans that size a grid to one wave
CARD_SMS = 132

_LOCK = threading.Lock()
_LOADED: Dict[pathlib.Path, ctypes.CDLL] = {}
# the compiler's output of each library this process built, by source name
# (what a source's extra flags ask it to report, e.g. ``-Xptxas=-v``)
LOGS: Dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """One kernel's CUDA source plus the flags it needs beyond
    ``NVCC_FLAGS``."""

    name: str
    path: pathlib.Path
    extra_flags: Tuple[str, ...] = ()

    def library(self) -> pathlib.Path:
        digest = hashlib.sha256(
            self.path.read_bytes()
            + " ".join(NVCC_FLAGS + self.extra_flags).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return found


def build_all(sources: Sequence[KernelSource]) -> None:
    """Compile every source whose library is missing, all in parallel;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        lib = src.library()
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *src.extra_flags, "-o", str(tmp),
               str(src.path)]
        jobs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.path.name}:\n{log}")
        else:
            os.replace(tmp, lib)          # atomic: never a partial library
            LOGS[src.name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(src: KernelSource) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = src.library()
    with _LOCK:
        if lib not in _LOADED:
            build_all([src])
            _LOADED[lib] = ctypes.CDLL(str(lib))
        return _LOADED[lib]
