"""Build the port's CUDA sources with plain nvcc and load them with ctypes.

Each source in csrc/ becomes one shared library with a plain C interface,
compiled for sm_90a at first use into `build/torch_kernels/` at the repo
root. The library's name carries a hash of the source, the csrc/ headers
and the flags, so a changed source or header builds anew; the build writes
a temporary file and renames it into place, so concurrent processes never
load a half-written library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    """$CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    """Where the library of csrc/<source> goes, named by a hash of the
    source, every csrc/*.cuh header it may include, and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def sass_count(library: Path, opcode: str) -> int:
    """How many SASS instructions of `opcode` (e.g. HGMMA) the built
    library holds, from cuobjdump beside nvcc."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {library.name}:\n"
                           f"{proc.stderr}")
    word = re.compile(rf"\b{opcode}\b")
    return sum(1 for line in proc.stdout.splitlines() if word.search(line))


def build(source: str) -> Path:
    """Compile csrc/<source> unless its library exists; returns its path.
    The compiler's report (registers, spills) is kept beside it as .log."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>, once per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
