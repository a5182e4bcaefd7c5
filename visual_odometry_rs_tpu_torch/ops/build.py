"""Builds the package's native sources and loads them with ctypes.

Every ``csrc/<name>.cu`` (a CUDA source, built with ``nvcc``) or
``csrc/<name>.cpp`` (host C++, built with ``g++`` or ``$CXX``) becomes
``_build/<name>_<key>.so``, where the key is a hash of the source, of the
headers in ``csrc/`` and of the flags, so an edited source is rebuilt and an
unchanged one is not.  A build writes a temporary file and renames it into
place, so processes that build the same source at once do not see a partial
library.  The build happens at first use, never at import: importing this
package needs no compiler.  ``build_all`` starts one compiler per source at
the same time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"
# FMA contraction stays on (nvcc's default) and -use_fast_math stays off
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
CXX_LIBS = ("-lz", "-lpthread")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` if it exists, else ``csrc/<name>.cpp``."""
    cuda = SOURCE_DIR / f"{name}.cu"
    return cuda if cuda.exists() else SOURCE_DIR / f"{name}.cpp"


def _command(source: Path, out: str) -> list:
    if source.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-o", out, str(source)]
    return [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", out, str(source), *CXX_LIBS]


def build_library(name: str) -> Tuple[Path, float, str]:
    """Build ``csrc/<name>.cu`` (or ``.cpp``) if it is not built yet.

    Returns ``(path, build seconds, compiler output)``; seconds is 0 and the
    output empty when the library for these sources and flags exists.
    """
    source = source_path(name)
    digest = hashlib.sha256(source.read_bytes())
    if source.suffix == ".cu":
        for header in sorted(SOURCE_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    lib_path = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        command = _command(source, tmp)
        proc = subprocess.run(command, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(command[0])} failed on {source.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, time.perf_counter() - start, proc.stdout + proc.stderr


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Build several sources at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build_library, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (or ``.cpp``); the caller sets
    ``argtypes``."""
    return ctypes.CDLL(str(build_library(name)[0]))
