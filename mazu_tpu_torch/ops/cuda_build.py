"""Build of the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. ``compile_library``
compiles one with ``nvcc`` for sm_90a into ``build/`` beside the package,
named by a hash of its source, unless that build exists; the wrappers load
the result with ``ctypes``. ``compile_all`` runs one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
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


def compile_all(sources) -> list[tuple[Path, str]]:
    """``compile_library`` for each source, the compilers running together."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(compile_library, sources))
