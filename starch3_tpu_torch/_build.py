"""Build the port's native libraries at first use, from its own sources.

- ``build(name)``: a CUDA kernel, ``csrc/<name>.cu``, compiled with
  ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
  (loaded with ``ctypes``).  A missing ``nvcc`` or a failed build raises
  with the compiler's output: there is no fallback.
- ``build_host(name, src, flags)``: a host library compiled with ``g++``
  (the native runtime, ``runtime/runtime.cpp``).

Each library lands in ``build/`` at the repository root, named by a hash
of the source and the flags, so a changed source or flag builds anew and
an unchanged one is reused.  Concurrent builders (test workers, threads)
take a file lock per library, and the finished file replaces a temporary
one atomically, so no process ever loads half a library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _compile(name: str, src: Path, flags: tuple[str, ...], compiler) -> Path:
    """Path of ``build/<name>-<hash>.so`` for ``src`` built with
    ``flags``, running ``compiler()`` (the compiler's path) only when that
    library does not exist yet.  The compiler's output is kept beside it
    as ``<name>-<hash>.log``."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    stem = f"{name}-{digest.hexdigest()[:16]}"
    lib = BUILD_DIR / f"{stem}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while we waited
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                proc = subprocess.run(
                    [compiler(), *flags, "-o", tmp, str(src)],
                    capture_output=True, text=True, timeout=600,
                )
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"building {src} took more than 600 s") from None
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"building {src} failed (exit {proc.returncode}):\n{log}")
            (BUILD_DIR / f"{stem}.log").write_text(log)
            os.replace(tmp, lib)  # atomic: concurrent loaders never see half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def build(name: str) -> Path:
    """The CUDA library of ``csrc/<name>.cu`` (``-Xptxas -v`` puts each
    kernel's registers and shared memory in its log)."""
    return _compile(name, CSRC / f"{name}.cu", NVCC_FLAGS, find_nvcc)


def build_host(name: str, src: Path, flags: tuple[str, ...]) -> Path:
    """A host library from the C++ source ``src``, built with ``g++``."""

    def gxx() -> str:
        found = shutil.which("g++")
        if found is None:
            raise RuntimeError("g++ not found on $PATH; the native runtime cannot be built")
        return found

    return _compile(name, Path(src), tuple(flags), gxx)
