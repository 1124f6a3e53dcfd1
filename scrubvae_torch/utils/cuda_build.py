"""The port's hand-written kernels (``scrubvae_torch/csrc/*.cu``) as shared
libraries with a plain C interface: each source is compiled with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at first use (keyed by the source
and the flags, so an edit builds anew) and loaded with ctypes.

A ``CudaLibrary`` owns one source and its loaded handle; ``bind`` declares
the argument and return types of its C functions once, when it loads.
``launch`` calls a C entry that returns a ``cudaError`` and raises on a
non-zero one. ``drop_all`` forgets every handle (``utils.retry`` does so
between attempts), so the next launch loads the build again.

A kernel wrapper declared with ``counted`` has a ``launches`` attribute,
which it increments by the kernel launches each call makes;
``launch_counts`` reads every declared wrapper's, and
``train.graph.StepGraph`` advances them at each replay of a captured step.
So a new kernel is one ``csrc/*.cu`` source, one ``CudaLibrary`` and one
wrapper declared with ``counted``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

from scrubvae_torch.utils.retry import retry_build

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "counted", "drop_all", "launch_counts"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBRARIES: List["CudaLibrary"] = []
_COUNTED: List[Callable] = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaLibrary:
    """The kernel source ``source`` built and loaded on demand."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.bind = bind
        self.handle: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        _LIBRARIES.append(self)

    def build(self, force: bool = False) -> Path:
        """Compile the source into a shared library and return its path;
        reuse an existing build unless ``force``. The assembler's report
        (registers, spills of each kernel) is kept beside it, with the
        suffix ``.ptxas.txt``. Raises "nvcc killed by signal" where a
        signal ended ``nvcc`` (which ``utils.retry`` retries) and "nvcc
        failed" where it rejected the source (which it does not)."""
        key = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{self.source.stem}_{key.hexdigest()[:16]}.so"
        if out.exists() and not force:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode < 0:
            raise RuntimeError(f"nvcc killed by signal {-res.returncode} ({' '.join(cmd)}):\n{res.stderr}")
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
        out.with_suffix(".ptxas.txt").write_text(res.stderr)
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first where needed (under the build's
        retry policy)."""
        with self._lock:
            if self.handle is None:
                lib = ctypes.CDLL(str(retry_build(self.build)))
                self.bind(lib)
                self.handle = lib
            return self.handle

    def launch(self, entry: str, *args) -> None:
        """Call the C function ``entry`` of the loaded library with
        ``args``; raises where it returns a non-zero ``cudaError``."""
        err = getattr(self.load(), entry)(*args)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")

    def drop(self) -> None:
        """Forget the loaded library; the next launch loads the build again."""
        with self._lock:
            self.handle = None


def drop_all() -> None:
    """``drop`` every library."""
    for lib in _LIBRARIES:
        lib.drop()


def counted(fn: Callable) -> Callable:
    """Declare ``fn`` a kernel wrapper that counts its launches: its
    ``launches`` starts at 0, and ``launch_counts`` reads it."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> Dict[Callable, int]:
    """Each wrapper declared with ``counted`` (the module docstring) and
    its ``launches``, as they stand: those whose module has been imported."""
    return {fn: fn.launches for fn in _COUNTED}
