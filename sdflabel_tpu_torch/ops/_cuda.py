"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. ``build_all`` compiles
every source that has no up-to-date library with one ``nvcc`` process per
source, all started together, into ``csrc/build/lib<name>-<hash>.so``; the
hash covers the source text, every local header it includes (``#include
"..."``, followed transitively) and the flags, so an edited source or
header rebuilds every library that uses it.
Libraries load with ctypes; every pointer and the stream pass as
``c_void_p``. Each exported launcher returns ``cudaGetLastError()`` and
:class:`CudaKernel` raises on anything but 0.

Nothing here runs at import, so importing the package needs neither nvcc
nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
_COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
                 # no a*b+c -> fma contraction: the kernels repeat the plain
                 # versions' separately rounded products and sums
                 "-fmad=false"]
SOURCES = ("splat", "splat_bins", "nn", "select_mlp", "ce", "stage2_mlp")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_files(path: str, seen: list[str]) -> list[str]:
    """`path`, then each local header it includes that exists beside it,
    depth first, each once."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _LOCAL_INCLUDE.findall(text):
        header = os.path.join(os.path.dirname(path), inc.decode())
        if os.path.exists(header):
            _source_files(os.path.normpath(header), seen)
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(_COMMON_FLAGS).encode())
    for path in _source_files(os.path.join(CSRC, name + ".cu"), []):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every library that is missing; returns nvcc's log per source
    (ptxas register and shared-memory report included)."""
    with _LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in SOURCES:
            out = library_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *_COMMON_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, out, tmp, proc in procs:
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def _load(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        build_all()
    lib = ctypes.CDLL(path)
    lib.sdl_error_string.argtypes = [ctypes.c_int]
    lib.sdl_error_string.restype = ctypes.c_char_p
    with _LOCK:
        _LIBS[name] = lib
    return lib


def query(lib: str, symbol: str, *args: int) -> int:
    """Call an exported ``int symbol(int, ...)`` that launches nothing
    (a tile-size query), building the library first if needed."""
    fn = getattr(_load(lib), symbol)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return fn(*args)


class CudaKernel:
    """One exported launcher of one library, with its launch count.

    ``launches`` grows by one each time the launcher is called and returns
    without error; callers that want a per-run count set it to 0.
    """

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = _load(self.lib)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _load(self.lib).sdl_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


class KernelGroup:
    """One kernel's launch count over the designs that compute it: the sum
    of theirs. Setting it (to 0) sets each design's count."""

    def __init__(self, **designs: CudaKernel):
        self.designs = designs

    @property
    def launches(self) -> int:
        return sum(k.launches for k in self.designs.values())

    @launches.setter
    def launches(self, value: int) -> None:
        for k in self.designs.values():
            k.launches = value


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a raw cudaStream_t
    (without building a torch.cuda.Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (-1 in `shape` matches any size)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s != -1 and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
