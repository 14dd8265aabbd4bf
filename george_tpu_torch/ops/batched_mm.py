# -*- coding: utf-8 -*-
"""Batched ``A[b] @ B[b]^T`` over chain-major (B, N, N) tensors.

The unit of work of the blocked dense engine's Schur downdates, and the
function the JAX package's ``benchmarks/pallas_batched_mm.py`` measures
with two TPU kernels (``make_chunk``, ``make_batchdim``).  Two
implementations of it live here:

  * :func:`batched_mmT` — the hand-written CUDA kernel
    (``csrc/batched_mmT.cu``): 128 x 128 output tiles, K-slices through a
    three-stage ``cp.async`` ring, float32 on the tensor cores as three
    TF32 products (3xTF32, float32 accuracy), float64 in FP64 FMAs;
    ``chains_per_block`` is the number of chains one thread block takes
    in turn (the TPU script's chunk C).  Its ``launches`` attribute
    counts kernel launches.
  * :func:`batched_mmT_torch` — the plain PyTorch version,
    ``torch.einsum("bij,bkj->bik")`` (the TPU script's ``xla`` baseline).

:func:`batched_mmT` dispatches on the device of its inputs: CUDA tensors
go to the kernel (which raises on anything it does not take), CPU tensors
to the plain version.  There is no fallback between the two.  The engine
itself (``ops/dense_mxu.py``) keeps ``torch.matmul`` for its downdates, as
the JAX engine kept XLA's einsum.
"""

import ctypes

import torch

from .. import _build

__all__ = ["CHAINS_PER_BLOCK", "batched_mmT", "batched_mmT_torch"]

SOURCE = "batched_mmT.cu"
_CTYPE = {torch.float32: "float", torch.float64: "double"}
# The chain counts a block may take (the kernel's template instances, the
# counts tools/batched_mm.py sweeps).
CHAINS_PER_BLOCK = (1, 8, 32, 64)


def instance(dtype):
    """The kernel instantiation for ``dtype`` (:class:`_build.Instance`)."""
    return _build.Instance(SOURCE, {"MM_T": _CTYPE[dtype]})


def _library(dtype):
    lib = _build.load(instance(dtype))
    if not getattr(lib, "_mm_checked", False):
        lib.batched_mmT_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.batched_mmT_launch.restype = ctypes.c_int
        lib.batched_mmT_error_string.argtypes = [ctypes.c_int]
        lib.batched_mmT_error_string.restype = ctypes.c_char_p
        lib.batched_mmT_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.batched_mmT_config.restype = None
        cfg = (ctypes.c_int * 5)()
        lib.batched_mmT_config(cfg)
        size = torch.empty((), dtype=dtype).element_size()
        if cfg[0] != size:
            raise RuntimeError("batched_mmT library has {0}-byte scalars, "
                               "not {1}".format(cfg[0], size))
        lib._mm_checked = True
    return lib


def _check(a, b):
    if a.dtype not in _CTYPE:
        raise TypeError("a must be float32 or float64, got {0}".format(
            a.dtype))
    if a.dim() != 3 or a.shape[1] != a.shape[2] or a.shape[1] < 1:
        raise ValueError("a must be (B, N, N), got {0}".format(
            tuple(a.shape)))
    if b.shape != a.shape or b.dtype != a.dtype or b.device != a.device:
        raise ValueError("b must match a: {0} {1} on {2}".format(
            tuple(a.shape), a.dtype, a.device))


def batched_mmT_torch(a, b):
    """The plain PyTorch version: ``einsum("bij,bkj->bik", a, b)``."""
    _check(a, b)
    return torch.einsum("bij,bkj->bik", a, b)


def batched_mmT(a, b, chains_per_block=1):
    """``O[b] = a[b] @ b[b]^T`` for (B, N, N) tensors.

    CUDA tensors (contiguous, float32 or float64) launch the kernel on the
    current stream without synchronisation; CPU tensors take
    :func:`batched_mmT_torch`.
    """
    _check(a, b)
    if a.device.type == "cpu":
        return batched_mmT_torch(a, b)
    if a.device.type != "cuda":
        raise ValueError("no batched_mmT for device {0}".format(a.device))
    if chains_per_block not in CHAINS_PER_BLOCK:
        raise ValueError("chains_per_block must be one of {0}, got {1}"
                         .format(CHAINS_PER_BLOCK, chains_per_block))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    nb, n = a.shape[0], a.shape[1]
    if -(-nb // chains_per_block) > 65535:
        raise ValueError("{0} chains at {1} a block exceed the grid's 65535 "
                         "rows".format(nb, chains_per_block))
    out = torch.empty_like(a)
    if nb == 0:
        return out
    # 16-byte copies where every row starts on 16 bytes, word copies else.
    vec = int(n * a.element_size() % 16 == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0)
    lib = _library(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.batched_mmT_launch(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), nb, n,
                                     chains_per_block, vec, stream)
    if err != 0:
        raise RuntimeError("batched_mmT launch failed: {0}".format(
            lib.batched_mmT_error_string(err).decode()))
    batched_mmT.launches += 1
    return out


batched_mmT.launches = 0
