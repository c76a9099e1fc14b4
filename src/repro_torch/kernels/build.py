"""The kernel layer's seam: the port's kernel table, the nvcc build of
``repro_torch/csrc``, and the one way a wrapper launches a kernel.

``TABLE`` declares every kernel wrapper once, with its library and its
role: it "counts" votes or computes "features". ``KERNELS`` (the libraries
``build()`` compiles) and ``wrappers()`` (whose ``.launches`` the analyzer
and the chip smoke read) come from it. Every wrapper goes through
``dispatch`` and ``launch``, which raises ``<wrapper>.launches`` — there
and nowhere else. ``launch`` looks the library up through ``load`` at each
call, so a tool may swap ``load`` for a variant library.

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
import dataclasses
import hashlib
import importlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.analysis.scopes import scope

__all__ = [
    "KERNELS", "NVCC_FLAGS", "BUILD_DIR", "TABLE", "Kernel", "build", "call", "dispatch",
    "launch", "library_path", "load", "nvcc", "sources", "wrappers",
]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel wrapper of the port: its name, the kernels module that
    defines it, the library of ``csrc/<library>.cu`` it launches, and its
    role, "counts" or "features"."""

    name: str
    module: str
    library: str
    role: str

    @property
    def wrapper(self):
        """The wrapper function, imported at first use (its module imports
        this one)."""
        return getattr(importlib.import_module(f"repro_torch.kernels.{self.module}"), self.name)


TABLE = (
    Kernel("glcm_vote", "glcm_kernel", "glcm_vote", "counts"),
    Kernel("glcm_fused", "glcm_kernel", "glcm_fused", "counts"),
    Kernel("glcm_window", "glcm_kernel", "glcm_window", "counts"),
    Kernel("glcm_volume", "glcm_kernel", "glcm_volume", "counts"),
    Kernel("histogram", "histogram_kernel", "histogram", "counts"),
    Kernel("second_eigenvalue", "mcc_kernel", "haralick_mcc", "features"),
    Kernel("haralick_tail", "tail_kernel", "haralick_tail", "features"),
)
_LIBRARY = {k.name: k.library for k in TABLE}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = tuple(k.library for k in TABLE)  # one row a library
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


def wrappers() -> tuple:
    """The wrapper functions of ``TABLE``, in its order; each counts its
    kernel launches in ``.launches``."""
    return tuple(k.wrapper for k in TABLE)


def call(library: str, symbol: str, argtypes: list, *args) -> None:
    """Call ``symbol`` of ``csrc/<library>.cu``'s library, bound with
    ``argtypes`` and an int result (a CUDA error code), on ``args``; a
    nonzero code raises RuntimeError with CUDA's message."""
    lib = load(library)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    code = fn(*args)
    if code:
        msg = getattr(lib, f"{library}_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{library} kernel launch failed: CUDA error {code} ({msg(code).decode()})"
        )


def launch(wrapper, symbol: str, argtypes: list, device: torch.device, *args) -> None:
    """One launch of ``wrapper``'s kernel: ``symbol`` of its library called
    with ``args`` and, last, the current stream of ``device`` (``argtypes``
    ends with the stream's pointer) while ``device`` is current; then
    ``wrapper.launches`` goes up by one."""
    with torch.cuda.device(device):
        call(_LIBRARY[wrapper.__name__], symbol, argtypes, *args,
             torch.cuda.current_stream(device).cuda_stream)
    wrapper.launches += 1


def dispatch(wrapper, t: torch.Tensor, plain, kernel):
    """The wrapper rule, by the device of ``t``: on the CPU ``plain()``
    inside the ``kernel:<wrapper>`` scope, on a CUDA device ``kernel()``
    (which launches or raises, never falls back); another device raises."""
    if t.device.type == "cpu":
        with scope(f"kernel:{wrapper.__name__}"):
            return plain()
    if t.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {t.device}")
    return kernel()
