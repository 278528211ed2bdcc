"""Build a CUDA source of ``csrc/`` into a shared library with a plain C
interface, at first use, with ``nvcc``.

The library is named by a hash of its source and the flags, written under a
temporary name and renamed into place, so a build cut off midway leaves no
lock and no partial library. Libraries go to ``kernels/build/`` (listed in
``.gitignore``). Nothing here runs at import: the CPU tests import every
module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class NvccLibrary:
    """One ``.cu`` source and the shared library nvcc builds from it."""

    def __init__(self, source_name: str):
        self.source = CSRC / source_name
        self.build_log = ""

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this source exists."""
        so = self.library_path()
        log = so.with_suffix(".log")
        if so.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return so
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"{self.source.name}: nvcc not found (CUDA toolkit needed)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, so)
        return so
