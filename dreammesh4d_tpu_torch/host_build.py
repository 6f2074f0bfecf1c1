"""Build and load the port's host C++ libraries (the ``mc-cpu`` export path).

Each library is one source ``native/<name>.cpp`` with a plain C entry point:
``marching_tets`` (the isosurface extractor of ``export/isosurface.py``) and
``qem_decimate`` (the edge-collapse decimation of ``export/decimate.py``).
It is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` into
``_build/lib<name>_<hash>.so`` on first use and loaded with ``ctypes``; the
hash covers the source and the flags, so an edited source rebuilds.  This is
host code, as in the JAX package: it runs on the CPU whatever the device.

    from dreammesh4d_tpu_torch import host_build
    fn = host_build.entry("marching_tets", "mt_extract", argtypes)  # types bound once

A failed build raises; nothing falls back to a numpy version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, compiled first if it is
    not in ``_build/`` yet."""
    lib = _loaded.get(name)
    if lib is None:
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"host library build failed: {' '.join(cmd)} exited "
                                   f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = _loaded[name] = ctypes.CDLL(str(out))
    return lib


def entry(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``native/<name>.cpp``'s library with its
    argument and result types bound once per process."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[name, symbol] = fn
    return fn
