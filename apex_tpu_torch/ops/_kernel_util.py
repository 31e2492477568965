"""Build, load and count the port's CUDA kernels (counterpart of
``apex_tpu/ops/_pallas_util.py``).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
package's ``_build/`` directory (named by a hash of the source, so an
edited source is rebuilt) and loaded with ``ctypes``. Every C entry
returns ``cudaGetLastError()``; :func:`check_status` raises on a nonzero
code, so a launch the card refuses never passes silently.

Dispatch rule shared by every wrapper (:func:`use_kernel`): a CPU tensor
takes the plain PyTorch version, a CUDA tensor takes the kernel, anything
else raises. :func:`force_plain` is the one exception, an explicit switch
that ``chip_smoke.py`` uses to run the plain versions on the card and
compare streams.

Launch counts: each wrapper calls :func:`count_launch` right where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Iterator, List, Sequence

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# every kernel source of the port, by name (csrc/<name>.cu)
KERNEL_SOURCES = ("layer_norm", "paged_attention", "paged_mma",
                  "flash_attention", "flash_mma", "flash_varlen",
                  "flash_varlen_mma", "lm_head_loss", "lm_head_mma",
                  "fused_update", "megakernel", "quantize", "dropout")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the element types the kernels take, by the code their C entries read
# (csrc/common.cuh: apex::kF32, kBF16, kF16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPE_CODES)
HALF_DTYPES = (torch.bfloat16, torch.float16)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {}
_FORCE_PLAIN = [False]


# ---------------------------------------------------------------------------
# dispatch


def dtype_code(dtype: torch.dtype) -> int:
    """The C entries' code of a kernel element type: 0 fp32, 1 bf16, 2
    fp16; any other type raises."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernels take fp32, bf16 or fp16, got {dtype}")
    return _DTYPE_CODES[dtype]


def use_kernel(t: torch.Tensor) -> bool:
    """True -> launch the kernel; False -> run the plain version. A CPU
    tensor (or the :func:`force_plain` switch) takes the plain version; a
    CUDA tensor the kernel; any other device raises."""
    if t.device.type == "cpu" or _FORCE_PLAIN[0]:
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def use_kernel_as_asked(t: torch.Tensor, use_pallas) -> bool:
    """:func:`use_kernel` under a caller's ``use_pallas``: ``None`` is
    :func:`use_kernel`, ``False`` the plain version on every device, and
    ``True`` the kernel, raising for a tensor that is not on a CUDA device
    (there is no interpret mode to run it in)."""
    if use_pallas is None:
        return use_kernel(t)
    if not use_pallas:
        return False
    if t.device.type != "cuda":
        raise ValueError(f"use_pallas=True needs CUDA tensors (the kernels "
                         f"have no interpret mode), got {t.device}")
    return use_kernel(t)


@contextlib.contextmanager
def force_plain() -> Iterator[None]:
    """Run every wrapper's plain PyTorch version, even on CUDA tensors.
    For comparing the kernels with their plain versions end to end on the
    card; nothing on the serving path sets it."""
    prev = _FORCE_PLAIN[0]
    _FORCE_PLAIN[0] = True
    try:
        yield
    finally:
        _FORCE_PLAIN[0] = prev


# ---------------------------------------------------------------------------
# custom-gradient regions under amp's autocast

# set by amp.autocast while its mode is active: (apply, args, kwargs) ->
# outputs, the region run at its un-autocast input dtypes, mode suspended
_OPAQUE_HOOK = [None]


class OpaqueFunction(torch.autograd.Function):
    """Base of the port's custom-gradient regions over its kernels (JAX's
    ``custom_vjp``s: flash, LayerNorm / RMSNorm, the LM-head loss, dropout,
    the softmaxes, the cross entropies). Outside amp's autocast it is a
    plain ``torch.autograd.Function``; under it the region is opaque, as
    JAX's autocast binds a custom-VJP region unchanged: its float inputs
    go back to the dtypes they would have had without autocast and its
    body runs with no per-op casting."""

    @classmethod
    def apply(cls, *args, **kwargs):
        return opaque_call(super(OpaqueFunction, cls).apply, *args,
                           **kwargs)


def opaque_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as an opaque region under amp's autocast
    (:class:`OpaqueFunction`'s rule; for a kernel wrapper's branch that
    runs without autograd), a plain call otherwise."""
    hook = _OPAQUE_HOOK[0]
    if hook is None:
        return fn(*args, **kwargs)
    return hook(fn, args, kwargs)


# ---------------------------------------------------------------------------
# launch counters


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


# ---------------------------------------------------------------------------
# build + load


def nvcc_path() -> str:
    cands: List[str] = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's kernels are built from csrc/ at first use")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Dict]:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together. Returns, per name
    built, the compiler's output (``"log"``; ``-Xptxas -v``: registers,
    shared memory, spills) and its wall seconds (``"seconds"``). Raises
    with the log when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        # unique per process and thread: two builds of one source never
        # write the same file
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        log = BUILD_DIR / f"{name}.log"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT),
                           tmp, out, log)
    seconds: Dict[str, float] = {}
    while len(seconds) < len(procs):
        for name, (proc, _, _, _) in procs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.05)
    built: Dict[str, Dict] = {}
    failed: List[str] = []
    for name, (proc, tmp, out, log) in procs.items():
        text = log.read_text()
        built[name] = {"log": text, "seconds": seconds[name]}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def load_kernel(name: str,
                signatures: Dict[str, Sequence[type]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built first if needed),
    with ``argtypes``/``restype`` set for each entry in ``signatures`` —
    ``c_void_p`` for every pointer and the stream, so no pointer is cut to
    32 bits."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, args in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(args)
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(cond: bool, what: str) -> None:
    """Wrapper-side input check: a shape, dtype or layout the kernel does
    not take raises (never a quiet detour to the plain version)."""
    if not cond:
        raise ValueError(what)
