"""Build the CUDA sources in ``apex_tpu_torch/csrc`` and bind them.

Every ``csrc/*.cu`` file compiles in its own ``nvcc`` process for
``sm_90a`` — all started together — and one link step joins the
objects into a shared library with a plain C interface, loaded with
:mod:`ctypes`.  No source includes PyTorch's headers, which keeps a
cold build to seconds.  The library lands in
``apex_tpu_torch/_build/<hash>/``, named by a hash of the sources and
flags, so an edited kernel never loads a stale build.  Nothing is built
when this module is imported: the first kernel launch builds (or finds)
the library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises when that is not 0 and
counts the launches that went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libapex_tpu_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh (enum apex::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_build_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    usual install prefix, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: install the CUDA toolkit or set CUDA_HOME")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile and link the kernel library unless a build of the same
    sources exists; returns its path.  The compiler's output (``ptxas``
    register and shared-memory use per kernel) is kept in
    ``build.log`` beside the library."""
    out_dir = Path(build_dir) / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC_DIR),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp_lib = Path(tmp) / LIB_NAME
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                   *[str(obj) for _, obj, _ in procs]]
            link = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"kernel build failed ({', '.join(failed)}):\n"
                + "\n".join(log))
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _build_lock:
        lib = ctypes.CDLL(str(build_library()))
    lib.apex_error_string.argtypes = [ctypes.c_int]
    lib.apex_error_string.restype = ctypes.c_char_p
    return lib


_KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """One C entry point of the kernel library and its launch count.

    ``argtypes`` are the :mod:`ctypes` types of the entry point's
    arguments (``c_void_p`` for every pointer and the stream).
    :meth:`launch` calls it, raises if the launch was refused, and only
    then adds one to :attr:`launches` — the count that shows a run went
    through the kernel."""

    def __init__(self, name: str, symbol: str,
                 argtypes: Sequence[type]):
        if name in _KERNELS:
            raise ValueError(f"kernel {name!r} is already registered")
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        _KERNELS[name] = self

    @functools.cached_property
    def _fn(self):
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        err = self._fn(*args)
        if err != 0:
            msg = library().apex_error_string(err).decode()
            raise RuntimeError(
                f"{self.symbol} was not launched: CUDA error {err} ({msg})")
        self.launches += 1


def plain_path(*tensors: torch.Tensor) -> bool:
    """Which version a kernel wrapper runs: True (the plain PyTorch
    version) when every tensor lies on the CPU, False (the kernel) when
    every tensor lies on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}: kernels run on CUDA, "
                     "their plain versions on the CPU")


def check_dtype(name: str, t: torch.Tensor) -> int:
    """The kernel dtype code of ``t``; raises for a dtype the kernels
    do not take."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {t.dtype} is not supported by the "
                        f"CUDA kernel (float32 or bfloat16)")
    return code


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the raw handle a
    C entry point takes."""
    return torch.cuda.current_stream(device).cuda_stream


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in sorted(_KERNELS.items())}


def reset_launch_counts() -> None:
    for k in _KERNELS.values():
        k.launches = 0
