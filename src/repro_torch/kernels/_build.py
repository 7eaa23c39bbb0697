"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``.  Libraries land in ``repro_torch/_build/`` (listed
in ``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused.  The compiler's
output (with ptxas's register and spill report) is kept beside each
library as ``<library>.log``, so a reused library still has its report.
Nothing is built or
loaded at import time: the first launch of a kernel builds it, and
``build_all()`` builds every kernel at once, one ``nvcc`` process per
source, all started together.

Every library exports ``kernel_error_string(int)`` beside its launch
functions; each launch function returns the ``cudaGetLastError()`` code of
its launch, and ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: the kernels of this package: one source file and one library each
SOURCES = ("int4_matmul", "flash_prefill", "paged_decode", "ragged_decode",
           "w4a16_matmul", "lut4_matmul", "lut_mul4")

#: every flag that reaches nvcc (``-Xptxas -v`` only adds the report)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library (process-wide: a library is loaded once)
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            f"{CSRC_DIR} at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header
    under ``csrc/`` and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[bool, str]]:
    """Compile every library that is not built yet, one ``nvcc`` per source,
    all in parallel.  Returns {name: (compiled now, compiler output)} for
    every name; a reused library brings the output kept from its build.
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, result = {}, {}
    for name in names:
        target = library_path(name)
        log = target.with_name(target.name + ".log")
        if target.exists():
            result[name] = (False, log.read_text() if log.exists() else "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, log)
    failed = []
    for name, (proc, tmp, target, log) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, target)
        result[name] = (True, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return result


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed.  ``bind`` declares the launch functions' argtypes/restype once,
    when the library is first loaded."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        bind(lib)
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg: Optional[bytes] = lib.kernel_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {code} "
            f"({(msg or b'?').decode()})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (NULL for None: an absent operand)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
