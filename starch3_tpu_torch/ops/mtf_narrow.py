"""Narrow-alphabet MTF ranks, batched: the MTF stage of the bits 4, 5 and
6 tiers.

Counterpart of ``starch3_tpu/ops/mtf_narrow_pallas.py``
(``mtf_ranks_narrow_batch``).  The rank of the symbol at position i is
the number of symbols whose last occurrence before i is later than the
last occurrence of ``seq[i]``; symbols not seen yet are ordered by
``L0(s) = -1 - s`` (the initial MTF list).  Each row starts afresh.

``mtf_ranks_narrow_batch`` launches a hand-written CUDA kernel for a CUDA
tensor: at width 16 ``csrc/mtf_narrow.cu`` (one pass, the list in a
register), at widths 32/64 the windowed kernel of ``csrc/mtf_wide.cu``
(per-chunk tables, a carry scan, a warp per 1024-position chunk), loaded
through ``ops/mtf_wide.py``.  It takes the plain PyTorch version
``mtf_ranks_narrow_reference`` only for a tensor on the CPU, and never
falls back from one to the other.

A symbol ``>= width`` (or negative) matches no symbol plane, as in the
Pallas kernel: its rank is ``width`` and it leaves the recency order
unchanged.  Ranks past a row's true length are garbage the caller masks.
``mtf_ranks_narrow_host`` is the JAX module's host wrapper (numpy in,
numpy out) on an explicit device.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from starch3_tpu_torch.ops import mtf_wide

CHUNK = 4096  # positions per CUDA block at width 16; n_max must be a multiple
WIDTHS = (16, 32, 64)
_NEG = -(1 << 30)

# kernel launches made by mtf_ranks_narrow_batch (one per call on a CUDA
# tensor, or per replay of a CUDA graph that captured one:
# mtf_wide.count_launch), in all and by width (16: csrc/mtf_narrow.cu;
# 32/64: the windowed kernel of csrc/mtf_wide.cu); callers zero them and
# read them to prove a run used the kernels
launches = 0
width_launches = dict.fromkeys(WIDTHS, 0)


def mtf_ranks_narrow_reference(seqs: torch.Tensor, width: int = 16) -> torch.Tensor:
    """Plain PyTorch MTF ranks: the last-occurrence cummax formulation of
    ``starch3_tpu/ops/mtf_jax.py`` over a dense alphabet ``< width``.

    int32[B, n] -> int32[B, n].  Memory is O(B * n * width)."""
    b, n = seqs.shape
    dev = seqs.device
    sym = torch.arange(width, device=dev, dtype=torch.int32)
    pos = torch.arange(n, device=dev, dtype=torch.int32)
    onehot = seqs[:, :, None] == sym
    occ = torch.where(onehot, pos[None, :, None], _NEG)
    inc = torch.cummax(occ, dim=1).values
    excl = torch.cat([torch.full_like(inc[:, :1], _NEG), inc[:, :-1]], dim=1)
    last = torch.maximum(excl, -1 - sym)
    own = torch.where(onehot, last, _NEG).amax(dim=2, keepdim=True)
    return (last > own).sum(dim=2, dtype=torch.int32)


def mtf_ranks_narrow_batch(seqs: torch.Tensor, width: int = 16) -> torch.Tensor:
    """Batched narrow-alphabet MTF ranks: int32[B, n_max] (values <
    ``width``, one of 16/32/64) -> int32[B, n_max].

    On a CUDA tensor this launches the kernel (``n_max`` must be a
    multiple of 4096) on the current stream; on a CPU tensor it runs
    ``mtf_ranks_narrow_reference``."""
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width}")
    if seqs.dtype != torch.int32 or seqs.dim() != 2:
        raise TypeError(f"expected int32[B, n_max], got {seqs.dtype} {tuple(seqs.shape)}")
    if seqs.device.type == "cpu":
        return mtf_ranks_narrow_reference(seqs, width)
    if seqs.device.type != "cuda":
        raise ValueError(f"unsupported device {seqs.device}")
    if not seqs.is_contiguous():
        raise ValueError("seqs must be contiguous")
    b, n_max = seqs.shape
    if n_max % CHUNK:
        raise ValueError(f"n_max must be a multiple of {CHUNK}, got {n_max}")
    if width > 16 and n_max > mtf_wide.MAX_N:  # the windowed kernel's limit
        raise ValueError(f"n_max must be at most {mtf_wide.MAX_N}, got {n_max}")
    if seqs.data_ptr() % 16:
        raise ValueError("seqs must be 16-byte aligned")
    out = torch.empty_like(seqs)
    if b == 0:
        return out
    if width == 16:
        n_chunks = n_max // CHUNK
        lib = _lib()
        # each chunk's published table, then a tile counter, zeroed on the
        # stream: under a graph's capture a node of the graph, so that
        # every replay starts from zero
        tables = torch.zeros(b * n_chunks * 16 + 1, dtype=torch.int32, device=seqs.device)
        with torch.cuda.device(seqs.device):
            stream = torch.cuda.current_stream(seqs.device).cuda_stream
            err = lib.s3t_mtf_narrow16(
                seqs.data_ptr(), out.data_ptr(), tables.data_ptr(), b, n_chunks, stream,
            )
        if err != 0:
            raise RuntimeError(
                f"mtf_narrow kernel launch failed: CUDA error {err} "
                f"({lib.s3t_error_string(err).decode()})"
            )
    else:
        mtf_wide.launch(seqs, out, width, "mtf_narrow")
    mtf_wide.count_launch(sys.modules[__name__], width)
    return out


def mtf_ranks_narrow_host(seq_np: np.ndarray, device="cuda") -> np.ndarray:
    """Host wrapper, as the JAX package's: one row of symbols below 16,
    padded to a multiple of ``CHUNK`` (4096, the Pallas kernel's tile
    too), through ``mtf_ranks_narrow_batch`` at width 16 on ``device``;
    returns its ``n`` ranks."""
    n = seq_np.size
    padded = np.zeros((1, -(-n // CHUNK) * CHUNK), dtype=np.int32)
    padded[0, :n] = seq_np
    out = mtf_ranks_narrow_batch(torch.from_numpy(padded).to(device), 16)
    return out[0, :n].cpu().numpy()


_LIB = None


def _lib():
    """The width-16 kernel library, built from ``csrc/mtf_narrow.cu`` at
    first use."""
    global _LIB
    if _LIB is None:
        from starch3_tpu_torch._build import build

        lib = ctypes.CDLL(str(build("mtf_narrow")))
        lib.s3t_mtf_narrow16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.s3t_mtf_narrow16.restype = ctypes.c_int
        lib.s3t_error_string.argtypes = [ctypes.c_int]
        lib.s3t_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
