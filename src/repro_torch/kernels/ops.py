"""Kernel routing and the build of the port's CUDA kernels.

``resolve_impl`` keeps the reference's routing vocabulary
(``auto | kernel | einsum``) for ``FedConfig.sgd_impl`` / ``agg_impl`` /
``defense_impl`` / ``compress_impl`` and the LM ``Model``'s ``attn_impl`` /
``ssm_impl``, but the device decides, never a fallback:

  ``auto``   -- the CUDA kernel for tensors on the card, the plain PyTorch
                version for tensors on the CPU (which exist only when the
                caller asked for the CPU);
  ``kernel`` -- the CUDA kernel; asking for it on the CPU raises;
  ``einsum`` -- the plain PyTorch version, an explicit request (tests and
                the kernel-vs-plain comparison in ``chip_smoke.py``).

A kernel's wrapper called directly follows the ``auto`` rule: it launches
the kernel on CUDA tensors (or raises) and computes its plain version on
CPU tensors.  ``kernel`` on the CPU raises here, before any wrapper is
reached.

The kernels are CUDA C++ for ``sm_90a`` under ``src/repro_torch/csrc/``.
``library()`` compiles them with ``nvcc`` at first use (one ``nvcc -c``
per source, all started together, then one link) into a single shared
library with a plain C interface under ``src/repro_torch/_build/``, named
by a hash of the sources and flags, and loads it through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.kernels import ref

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("local_sgd.cu", "local_sgd_wide.cu", "local_sgd_general.cu", "local_sgd_tiled.cu",
           "fedavg_agg.cu", "defense_sim.cu", "compress.cu", "flash_attention.cu",
           "ssm_scan.cu", "count_sketch.cu")
HEADERS = ("local_sgd.cuh",)  # included by sources; part of the build's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# dynamic shared memory one block may opt into on Hopper (227 KB)
MAX_SMEM_BYTES = 232448

_IMPL_KINDS = ("sgd", "agg", "defense", "compress", "attn", "ssm")
_IMPL_VALUES = ("auto", "kernel", "einsum")


def resolve_impl(name: str, kind: str, device) -> str:
    """Resolve a kernel-routing knob to ``"kernel"`` or ``"einsum"`` for
    tensors on ``device`` (see the module docstring)."""
    if kind not in _IMPL_KINDS:
        raise ValueError(f"unknown impl kind {kind!r} (known: {list(_IMPL_KINDS)})")
    if name not in _IMPL_VALUES:
        raise ValueError(
            f"unknown {kind}_impl {name!r} (expected one of {list(_IMPL_VALUES)})"
        )
    on_card = torch.device(device).type == "cuda"
    if name == "auto":
        return "kernel" if on_card else "einsum"
    if name == "kernel" and not on_card:
        raise RuntimeError(
            f'{kind}_impl="kernel" needs tensors on a CUDA device, got {device}'
        )
    return name


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's kernels "
        "are CUDA C++ built with the CUDA toolkit at first use"
    )


def _build(lib_path: Path, nvcc: str) -> str:
    """Compile every source in parallel, link one shared library, move it
    into place atomically.  Returns the compiler's log (``-Xptxas=-v``
    prints each kernel's registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            log.append(f"[{src}]\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(tmp, lib_path.name)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib, *(obj for _s, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return "\n".join(log)


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    PI = ctypes.POINTER(I)
    lib.fedar_local_sgd.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P]
    lib.fedar_local_sgd.restype = I
    lib.fedar_local_sgd_ragged.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                           I, F, P]
    lib.fedar_local_sgd_ragged.restype = I
    lib.fedar_local_sgd_plan.argtypes = [I, I, I, I, PI, PI, PI, PI, PI, PI, PI, PI,
                                         ctypes.POINTER(L)]
    lib.fedar_local_sgd_plan.restype = I
    lib.fedar_local_sgd_attrs.argtypes = [I, I, I, I, PI, PI, PI]
    lib.fedar_local_sgd_attrs.restype = I
    lib.fedar_fedavg_agg.argtypes = [P, P, P, P, I, L, P]
    lib.fedar_fedavg_agg.restype = I
    lib.fedar_sketch_similarity.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.fedar_sketch_similarity.restype = I
    lib.fedar_pack_codes4.argtypes = [P, P, L, L, P]
    lib.fedar_pack_codes4.restype = I
    lib.fedar_unpack_codes4.argtypes = [P, P, L, L, L, P]
    lib.fedar_unpack_codes4.restype = I
    lib.fedar_topk_decode.argtypes = [P, P, P, L, L, L, I, I, I, P]
    lib.fedar_topk_decode.restype = I
    lib.fedar_topk_decode_attrs.argtypes = [I, PI, PI]
    lib.fedar_topk_decode_attrs.restype = I
    lib.fedar_flash_attention_bf16.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    lib.fedar_flash_attention_bf16.restype = I
    lib.fedar_flash_attention_fp32.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                               I, P]
    lib.fedar_flash_attention_fp32.restype = I
    lib.fedar_flash_attention_attrs.argtypes = [I, PI, PI, PI, PI]
    lib.fedar_flash_attention_attrs.restype = I
    lib.fedar_flash_attention_fp32_attrs.argtypes = [I, I, PI, PI, PI, PI]
    lib.fedar_flash_attention_fp32_attrs.restype = I
    lib.fedar_ssm_scan.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.fedar_ssm_scan.restype = I
    lib.fedar_ssm_scan_attrs.argtypes = [PI, PI, PI, PI]
    lib.fedar_ssm_scan_attrs.restype = I
    lib.fedar_count_sketch.argtypes = [P, P, P, P, P, I, L, I, I, I, P]
    lib.fedar_count_sketch.restype = I
    lib.fedar_count_sketch_smem.argtypes = [I]
    lib.fedar_count_sketch_smem.restype = L
    lib.fedar_cuda_error_string.argtypes = [I]
    lib.fedar_cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    nvcc = _nvcc()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update((CSRC / src).read_bytes())
    lib_path = BUILD_DIR / f"libfedar_kernels_{digest.hexdigest()[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    if not lib_path.exists():
        log = _build(lib_path, nvcc)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    lib.build_seconds = time.perf_counter() - t0
    lib.build_log = log
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its launch was
    refused, e.g. for too much shared memory, and never ran)."""
    if err != 0:
        msg = library().fedar_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Validate a kernel argument before its pointer crosses into C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """Kernel 8 routed by ``impl`` (the reference's ``ops.flash_attention``
    with ``use_pallas``): the CUDA kernel or ``ref.flash_attention_ref``.
    Shapes as ``kernels/flash_attention.py``."""
    if resolve_impl(impl, "attn", q.device) == "kernel":
        # imported here: the wrapper's module imports this one
        from repro_torch.kernels.flash_attention import flash_attention as kernel

        return kernel(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def ssm_scan(xd, logdecay, Bc, Cc, *, impl: str = "auto"):
    """Kernel 9 routed by ``impl``: the CUDA kernel, or the sequential
    ``ref.ssm_scan_ref`` cast to xd's dtype."""
    if resolve_impl(impl, "ssm", xd.device) == "kernel":
        from repro_torch.kernels.ssm_scan import ssm_scan as kernel

        return kernel(xd, logdecay, Bc, Cc)
    return ref.ssm_scan_ref(xd, logdecay, Bc, Cc).to(xd.dtype)
