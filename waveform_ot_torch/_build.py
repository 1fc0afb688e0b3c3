"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into a shared library with
a plain C interface, ``_build/<name>-<hash>.so``, where the hash covers the
source and the compiler flags, so an edited source or flag set builds anew
and an unchanged one is reused. The library is loaded with ``ctypes``; the
caller declares each function's ``argtypes``. What ``ptxas -v`` reported for
each kernel (registers, shared memory, spills) is kept beside the library
and read back by :func:`ptxas_log`.

A missing ``nvcc`` or a failed compile raises :class:`KernelBuildError`.
Nothing here substitutes another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_SRC_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "_build"
# where the CUDA toolkit installs itself when CUDA_HOME is not set
_CUDA_DEFAULT_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """A CUDA kernel library could not be compiled or loaded."""


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default home."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(_CUDA_DEFAULT_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        f"{_CUDA_DEFAULT_HOME / 'bin'}); the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by source and flags."""
    src = _SRC_DIR / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build exists; return the .so path."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: concurrent processes may race
    fd, tmp_name = tempfile.mkstemp(dir=out.parent, suffix=".so")
    os.close(fd)
    tmp = Path(tmp_name)
    cmd = [nvcc, *NVCC_FLAGS, str(_SRC_DIR / f"{name}.cu"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (rc={proc.returncode}) on {name}.cu:\n"
                f"{proc.stderr[-4000:]}")
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def ptxas_log(name: str) -> str:
    """What ``ptxas -v`` printed when ``csrc/<name>.cu`` was built."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()
