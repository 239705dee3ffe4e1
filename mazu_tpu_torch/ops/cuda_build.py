"""Build of the port's CUDA kernels and of its host library.

Each ``csrc/*.cu`` file has a plain C interface. ``compile_library``
compiles one with ``nvcc`` for sm_90a into ``build/`` beside the package,
named by a hash of its source, unless that build exists; the wrappers load
the result with ``ctypes``. ``compile_all`` runs one ``nvcc`` per source,
all at once. ``compile_host_library`` builds a host C++ source
(``csrc/host_reads.cpp``) the same way with the system C++ compiler.

Each build writes a file of its own and renames it into place, so builds
that race (test workers, processes of one run) leave one whole library.
A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"


def compile_library(source: Path) -> tuple[Path, str]:
    """Build ``source`` into a shared library unless this source's build
    exists. Returns (library path, compiler output: ptxas's register and
    spill report)."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stderr


HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")


def compile_host_library(source: Path, build_dir: Path | None = None) -> Path:
    """Build the host C++ ``source`` with the system C++ compiler (``$CXX``,
    else ``c++``) into ``build_dir`` (``build/`` by default),
    named by a hash of the source and the flags, unless that build exists.
    Raises when there is no compiler or the build fails."""
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    tag = hashlib.sha256(source.read_bytes() + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    lib = build_dir / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or "c++"
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} to build {source.name}")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {source.name} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def compile_all(sources) -> list[tuple[Path, str]]:
    """``compile_library`` for each source, the compilers running together."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(compile_library, sources))
