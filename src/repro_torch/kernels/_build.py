"""Build and load the port's hand-written CUDA kernels.

Each kernel's source is one ``csrc/<name>.cu`` file with a plain C
interface.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``<checkout>/build/kernels/`` and
loaded with :mod:`ctypes`; the library name carries a hash of the source, so
an edited kernel is rebuilt and a stale one is never loaded.
:func:`build` compiles several kernels at once (one ``nvcc`` process per
source, all started together), which is how ``chip_smoke.py`` builds.

Nothing here runs at import time, so every module of the port imports on a
host without ``nvcc`` or a card (where the wrappers run their plain PyTorch
versions on CPU tensors).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_KERNELS_DIR = Path(__file__).resolve().parent

#: Kernel name → CUDA source.
SOURCES = {
    "keygroup_partition": _KERNELS_DIR / "keygroup_partition" / "csrc" / "keygroup_partition.cu",
    "radix_sort": _KERNELS_DIR / "radix_sort" / "csrc" / "radix_sort.cu",
}

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (listed in .gitignore)."""
    return _KERNELS_DIR.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns seconds per kernel built (0.0 for one already on disk).  Raises
    with the compiler's output when any build fails.
    """
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            lib,
        )
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built first if needed (cached)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
