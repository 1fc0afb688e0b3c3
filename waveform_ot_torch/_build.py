"""Build the package's native libraries at first use and load them with ctypes.

One compile-and-cache path, :func:`build_library`, serves both toolchains:
the CUDA kernels ``csrc/<name>.cu`` (nvcc, :data:`NVCC_FLAGS`) and the host
C++ solvers ``native/src/wotnative.cpp`` (g++, :data:`GXX_FLAGS`). Each source
is compiled into a shared library with a plain C interface,
``_build/<stem>-<hash>.so``, where the hash covers the source and the compiler
flags, so an edited source or flag set builds anew and an unchanged one is
reused. The library is loaded with ``ctypes``; the caller declares each
function's ``argtypes``. What the compiler printed is kept beside the library
(``<stem>-<hash>.log.txt``); for nvcc that is ``ptxas -v``'s registers, shared
memory and spills of each kernel, read back by :func:`ptxas_log`.

A missing compiler or a failed compile raises :class:`KernelBuildError`.
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
from typing import Callable

_SRC_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "_build"
# where the CUDA toolkit installs itself when CUDA_HOME is not set
_CUDA_DEFAULT_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 600


class KernelBuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


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


def find_gxx() -> str:
    """Path of g++ on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise KernelBuildError("g++ not found on PATH; the native solvers need a C++ compiler")
    return found


def cached_path(src: Path, flags: tuple[str, ...]) -> Path:
    """Where the build of ``src`` with ``flags`` lives, keyed by both."""
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(flags).encode())
    return _BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_library(src: Path, find_compiler: Callable[[], str],
                  flags: tuple[str, ...]) -> Path:
    """Compile ``src`` with ``flags`` unless its build exists; return the .so path."""
    out = cached_path(src, flags)
    if out.exists():
        return out
    compiler = find_compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: concurrent processes may race
    fd, tmp_name = tempfile.mkstemp(dir=out.parent, suffix=".so")
    os.close(fd)
    tmp = Path(tmp_name)
    cmd = [compiler, *flags, str(src), "-o", str(tmp)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise KernelBuildError(f"{Path(compiler).name} on {src.name} did not run: {e}") from e
        if proc.returncode != 0:
            raise KernelBuildError(
                f"{Path(compiler).name} failed (rc={proc.returncode}) on {src.name}:\n"
                f"{proc.stderr[-4000:]}")
        out.with_suffix(".log.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def library_path(name: str) -> Path:
    """Where the build of the CUDA source ``csrc/<name>.cu`` lives."""
    return cached_path(_SRC_DIR / f"{name}.cu", NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc unless its build exists."""
    return build_library(_SRC_DIR / f"{name}.cu", find_nvcc, NVCC_FLAGS)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def ptxas_log(name: str) -> str:
    """What ``ptxas -v`` printed when ``csrc/<name>.cu`` was built."""
    return library_path(name).with_suffix(".log.txt").read_text()
