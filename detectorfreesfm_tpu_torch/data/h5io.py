"""Keypoint/match stores (the reference's src/utils/data_io.py protocol:
'/' in keys escaped as '+').

Port of the JAX package's data/h5io.py with both of its branches: HDF5
through h5py where it is installed, else `np.savez` at `path + ".npz"`.
h5py is imported only when a store is written or read (never at import
time), and the caller may force the npz branch with `use_h5py=False`.
Writes are atomic (a .tmp sibling, then os.replace), so a kill mid-write
never leaves a truncated store that a resuming run takes for a finished
stage.

`stored_path` names the file the writer writes: a stage check must look
for that file, not for `path` itself, which the npz branch never creates.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _h5py(use_h5py: Optional[bool]):
    """The h5py module, or None for the npz branch. None: h5py if it
    imports; False: npz; True: h5py, which must import."""
    if use_h5py is False:
        return None
    try:
        import h5py
    except ImportError:
        if use_h5py:
            raise
        return None
    return h5py


def _escape(k: str) -> str:
    return k.replace("/", "+")


def _unescape(k: str) -> str:
    return k.replace("+", "/")


def stored_path(path: str, use_h5py: Optional[bool] = None) -> str:
    """The file that save_h5(d, path, use_h5py) writes."""
    return path if _h5py(use_h5py) is not None else path + ".npz"


def save_h5(d: Dict[str, np.ndarray], path: str,
            use_h5py: Optional[bool] = None) -> str:
    """Write the store atomically; returns the path of the file written."""
    h5py = _h5py(use_h5py)
    if h5py is None:
        np.savez(path + ".npz.tmp", **{_escape(k): v for k, v in d.items()})
        # np.savez appends .npz to names without it
        os.replace(path + ".npz.tmp.npz", path + ".npz")
        return path + ".npz"
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        for k, v in d.items():
            f.create_dataset(_escape(k), data=np.asarray(v))
    os.replace(tmp, path)
    return path


def load_h5(path: str, use_h5py: Optional[bool] = None
            ) -> Dict[str, np.ndarray]:
    h5py = _h5py(use_h5py)
    if h5py is None:
        with np.load(path + ".npz") as z:
            return {_unescape(k): z[k] for k in z.files}
    out = {}
    with h5py.File(path, "r") as f:
        for k in f.keys():
            out[_unescape(k)] = f[k][()]
    return out
