"""Build the CUDA sources of ``repro_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/repro_torch/lib<name>-<hash>.so`` at the root of the
checkout, where ``<hash>`` covers the source, every ``csrc/*.cuh`` header it
includes (directly or through another header) and the compiler flags: a
changed source or header builds anew, an unchanged one is loaded as it is. The build
happens at first use; ``build()`` compiles several sources at once, one
nvcc process each. Libraries are loaded with ``ctypes``.

The flags target Hopper (``sm_90a``) and keep IEEE arithmetic: precise
division, no flush to zero, and never ``--use_fast_math`` — the image kernels
bin values with divisions that must match the PyTorch binning bit for bit.

Nothing here runs on import: this module imports on machines with no
compiler and no card, and only a call to ``build`` or ``load`` needs nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "KERNELS", "NVCC_FLAGS", "BUILD_DIR", "build", "library_path", "load", "nvcc", "sources",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("glcm_vote", "glcm_fused", "glcm_window", "glcm_volume", "histogram", "haralick_mcc",
           "haralick_tail")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-prec-div=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under PyTorch's idea of CUDA_HOME."""
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            path = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are compiled at "
            "first use; put nvcc on PATH or set CUDA_HOME"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` followed by every local header it includes,
    directly or through another header, each once, in include order."""
    found = [CSRC / f"{name}.cu"]
    for path in found:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.exists() and header not in found:
                found.append(header)
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: the name
    hashes the source, its local headers and the flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _report_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every named source whose library is missing, all nvcc
    processes at once, and return ``{name: ptxas report}`` (registers,
    shared memory and spills per kernel, as ``-Xptxas -v`` prints them).
    Raises RuntimeError with nvcc's output when a compile fails."""
    pending = [n for n in names if not library_path(n).exists()]
    if pending:
        exe = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in pending:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            output, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode})\n{output}")
                tmp.unlink(missing_ok=True)
                continue
            _report_path(name).write_text(output)
            os.replace(tmp, library_path(name))  # atomic: readers see whole files
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {
        n: _report_path(n).read_text() if _report_path(n).exists() else "" for n in names
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
