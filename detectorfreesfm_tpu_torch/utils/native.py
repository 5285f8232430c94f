"""Build and load the port's small C++ helpers (csrc/*.cpp) with g++.

Each library is built at first use into the gitignored build/native/ at
the repo root (never into native/), named by a hash of its source, flags
and libraries, through a temporary file renamed into place, so that two
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# What build() raises when g++, a library or the load fails.
BUILD_ERRORS = (OSError, RuntimeError, subprocess.SubprocessError)


def library_path(source: Path, libs: Sequence[str] = ()) -> Path:
    """build/native/lib<stem>_<hash of source, flags and libs>.so"""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(GXX_FLAGS + tuple(libs)).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Build `source` (once) and load it; raises one of BUILD_ERRORS."""
    so = library_path(source, libs)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(source), *libs],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed: {proc.stderr.strip()}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
