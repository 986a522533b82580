"""Build a kernel's CUDA source with nvcc and load it with ctypes.

Each kernel of the port is one ``csrc/*.cu`` file with a plain C
interface.  `build` compiles it for ``sm_90a`` into a shared library under
the repository's ``build/kernels/`` (gitignored); the library's name
carries a hash of the source and the flags, so an edited source never
loads a stale build, and the file appears by an atomic rename, so a
concurrent builder sees all or none of it.  `build` takes no lock: two
sources build in parallel (``chip_smoke.py`` starts them together).
`load` builds if needed, binds the entry points once per library name and
keeps the handle.  Nothing here runs at import, so the CPU tests import
the kernel modules freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc(source: Path) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f"no CUDA toolkit (nvcc) found to build "
                           f"{source.name}")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: Path, name: str) -> Path:
    """Compile `source` (once per source and flags) into
    ``build/kernels/lib<name>-<hash>.so`` and return the library's path."""
    tag = hashlib.sha1(source.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(source), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                           f"{source.name}:\n{res.stderr}")
    os.replace(tmp, out)        # atomic: a concurrent builder sees all or none
    return out


def load(source: Path, name: str,
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build if needed, load, and `bind` the C entry points (argtypes and
    restype) the first time; later calls return the same handle."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, name)))
            bind(lib)
            _libs[name] = lib
        return lib
