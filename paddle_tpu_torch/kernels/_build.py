"""Build the port's CUDA kernels on first use.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into an
object, all sources at once in parallel processes; the objects link into
one shared library with a plain C interface, which the kernel wrappers
load through ``ctypes``.  Sources include no PyTorch headers, so a build
takes seconds.  Outputs land in ``paddle_tpu_torch/_build/`` (git-ignored)
under names carrying the content hash of the sources and of the headers
they share (``csrc/*.cuh``): a changed source or header builds a new
library, an unchanged one is loaded as it is.  A missing ``nvcc`` or a
failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


class BuildError(RuntimeError):
    """nvcc is missing or a kernel source did not compile or link."""


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The headers the sources include (``#include "x.cuh"``)."""
    return sorted(CSRC.glob("*.cuh"))


def library_path():
    """Where the library of the current sources and headers lives: its
    name carries their content hash."""
    return BUILD_DIR / ("libpaddle_tpu_torch_kernels-%s.so"
                        % _digest(sources() + headers()))


def _digest(paths):
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels build on a machine with the CUDA "
                     "toolkit")


def _run_all(cmds):
    """Start every command at once; raise with the output of any failure,
    else return the commands' joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], False
    for cmd, p in procs:
        out, _ = p.communicate()
        logs.append("$ %s\n%s" % (" ".join(cmd), out))
        failed = failed or p.returncode != 0
    if failed:
        raise BuildError("CUDA kernel build failed:\n" + "\n".join(logs))
    return "\n".join(logs)


def build(ptxas_info=False):
    """Compile the library if its sources changed; returns ``(path,
    log)``, where ``log`` is the compiler's output ("" when the library
    was already built).  ``ptxas_info`` rebuilds with ``-Xptxas -v``
    (registers, shared memory and spills of every kernel)."""
    srcs = sources()
    if not srcs:
        raise BuildError("no CUDA sources under %s" % CSRC)
    lib_path = library_path()
    if lib_path.is_file() and not ptxas_info:
        return lib_path, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if ptxas_info else []
    pid = os.getpid()
    objs, cmds = [], []
    for src in srcs:
        # per-process output names: concurrent builders never share a file
        obj = BUILD_DIR / ("%s-%s.%d.o" % (src.stem, _digest([src]), pid))
        objs.append(obj)
        cmds.append([nvcc, *ARCH_FLAGS, *CFLAGS, *extra, "-c", str(src),
                     "-o", str(obj)])
    log = _run_all(cmds)
    tmp = lib_path.with_suffix(".so.%d" % pid)
    log += "\n" + _run_all([[nvcc, *ARCH_FLAGS, "-shared",
                             *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return lib_path, log


def library():
    """The loaded kernel library (built on first use), with every C
    function's ``argtypes``/``restype`` declared."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            p, i, ll, f = (ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_float)
            lib.paddle_flash_fwd_bshd.argtypes = [
                p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, i, f, i,
                p]
            lib.paddle_flash_fwd_bshd.restype = i
            # A': kernel A's arguments, then block_q, block_k, stream
            lib.paddle_flash_fwd_pipelined.argtypes = [
                p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, i, f, i,
                i, i, p]
            lib.paddle_flash_fwd_pipelined.restype = i
            lib.paddle_flash_fwd_pipelined_smem.argtypes = [i, i, i, i]
            lib.paddle_flash_fwd_pipelined_smem.restype = ll
            # the 16-bit A' (tensor maps, tensor cores): A''s arguments
            lib.paddle_flash_fwd_pipelined_tc.argtypes = \
                lib.paddle_flash_fwd_pipelined.argtypes
            lib.paddle_flash_fwd_pipelined_tc.restype = i
            lib.paddle_flash_fwd_pipelined_tc_smem.argtypes = [i, i, i]
            lib.paddle_flash_fwd_pipelined_tc_smem.restype = ll
            # the tensor-core forward: A''s arguments
            lib.paddle_flash_fwd_tc.argtypes = \
                lib.paddle_flash_fwd_pipelined.argtypes
            lib.paddle_flash_fwd_tc.restype = i
            lib.paddle_flash_fwd_tc_smem.argtypes = [i, i, i]
            lib.paddle_flash_fwd_tc_smem.restype = ll
            lib.paddle_layer_norm_fwd.argtypes = [
                p, p, p, p, p, p, i, i, f, i, i, p]
            lib.paddle_layer_norm_fwd.restype = i
            # q, k, v, dout, lse, delta, then the outputs, B S H D, eight
            # strides, causal, scale, dtype, tile rows, stream
            strides = [ll] * 8
            lib.paddle_flash_bwd.argtypes = [
                p, p, p, p, p, p, p, p, p, i, i, i, i, *strides, i, f, i, i,
                p]
            lib.paddle_flash_bwd_dq.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, *strides, i, f, i, i, p]
            lib.paddle_flash_bwd_dkv.argtypes = [
                p, p, p, p, p, p, p, p, i, i, i, i, *strides, i, f, i, i, p]
            for fn in (lib.paddle_flash_bwd, lib.paddle_flash_bwd_dq,
                       lib.paddle_flash_bwd_dkv):
                fn.restype = i
            lib.paddle_flash_bwd_smem.argtypes = [i, i, i]
            lib.paddle_flash_bwd_smem.restype = ll
            for fn in (lib.paddle_flash_bwd_tc_smem,
                       lib.paddle_flash_bwd_merged_tc_smem):
                fn.argtypes = [i, i]
                fn.restype = ll
            lib.paddle_layer_norm_bwd.argtypes = [
                p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
            lib.paddle_layer_norm_bwd.restype = i
            lib.paddle_layer_norm_bwd_parts.argtypes = [i, i, i, i]
            lib.paddle_layer_norm_bwd_parts.restype = i
            # x, [labels], outputs, then N V dtype stream
            lib.paddle_ce_lse.argtypes = [p, p, i, i, i, p]
            lib.paddle_ce_fwd.argtypes = [p, p, p, p, i, i, i, p]
            lib.paddle_ce_bwd.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.paddle_softmax_fwd.argtypes = [p, p, i, i, i, p]
            for fn in (lib.paddle_ce_lse, lib.paddle_ce_fwd,
                       lib.paddle_ce_bwd, lib.paddle_softmax_fwd):
                fn.restype = i
            lib.paddle_cuda_error_string.argtypes = [i]
            lib.paddle_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def current_stream(device):
    """PyTorch's current stream handle for ``device``, which must be the
    current device: the library launches on the calling thread's
    current device."""
    import torch
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError("tensor on %s, current device is cuda:%d; launch "
                         "under torch.cuda.device(%s)"
                         % (device, torch.cuda.current_device(), device))
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        name = library().paddle_cuda_error_string(err).decode()
        raise RuntimeError("%s failed: cudaError %d (%s)" % (what, err, name))
