"""Wide-alphabet MTF ranks, batched: the bits==8 tier's MTF stage.

Counterpart of ``starch3_tpu/ops/mtf_pallas.py``: ``mtf_ranks_wide_batch``
mirrors ``mtf_ranks_pallas_batch`` (widths 128 and 256) and
``mtf_ranks_wide`` mirrors ``mtf_ranks_pallas`` (one row, width 256).
The rank of the symbol at position i is the number of symbols whose last
occurrence before i is later than the last occurrence of ``seq[i]``;
symbols not seen yet are ordered by ``L0(s) = -1 - s``.  Each row starts
afresh.

``mtf_ranks_wide_batch`` launches the hand-written CUDA kernel
(``csrc/mtf_wide.cu``: per-chunk tables, a carry scan, then a warp per
chunk walking 32 positions a step) for a CUDA tensor, and takes the plain
PyTorch version ``mtf_ranks_wide_reference`` only for a tensor on the CPU.  It
never falls back from one to the other.

A symbol ``>= width`` (or negative) matches no symbol, as in the Pallas
kernel: its rank is ``width`` and it leaves the recency order unchanged.
Ranks past a row's true length are garbage the caller masks.
``mtf_ranks_wide_host`` is the host wrapper (numpy in, numpy out) of
both ``mtf_ranks_pallas_host`` and ``mtf_jax.mtf_ranks_jax``, on an
explicit device.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import threading

import numpy as np
import torch

CHUNK = 1024  # positions per chunk of the kernel; n_max must be a multiple
WIDTHS = (128, 256)
MAX_N = 1 << 22
_NEG = -(1 << 30)

# kernel launches made by mtf_ranks_wide_batch (one per call on a CUDA
# tensor, or per replay of a CUDA graph that captured one), in all and by
# width; callers zero them and read them to prove a run used the kernel at
# the widths it should
launches = 0
width_launches = dict.fromkeys(WIDTHS, 0)
_capture = threading.local()


@contextlib.contextmanager
def captured_launches():
    """While this thread captures a CUDA graph, the MTF wrappers' launches
    are recorded, not counted: a capture launches nothing.  Yields the
    list of ``(module, width)`` recorded; each replay of the graph counts
    them (``count_replayed``)."""
    _capture.tally = tally = []
    try:
        yield tally
    finally:
        _capture.tally = None


def count_launch(module, width: int) -> None:
    """One launch of ``module``'s kernel (this module's, or
    ``mtf_narrow``'s) at ``width``, counted in its ``launches`` and
    ``width_launches``; inside ``captured_launches`` on this thread,
    recorded for the graph instead."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally.append((module, width))
    else:
        count_replayed(((module, width),))


def count_replayed(tally) -> None:
    """Count the launches a replayed graph's capture recorded."""
    for module, width in tally:
        module.width_launches[width] += 1
        module.launches += 1


def mtf_ranks_wide_reference(seqs: torch.Tensor, width: int = 256) -> torch.Tensor:
    """Plain PyTorch MTF ranks: the tiled scan of
    ``starch3_tpu/ops/mtf_jax.py``, chunk by chunk with a ``[B, width]``
    last-occurrence carry seeded with L0.

    int32[B, n] -> int32[B, n].  Memory is O(B * CHUNK * width): the
    untiled cummax would hold ``[B, n, width]`` tensors, 2.8 GB each at
    (3, 901,120)."""
    b, n = seqs.shape
    dev = seqs.device
    sym = torch.arange(width, device=dev, dtype=torch.int32)
    carry = (-1 - sym).expand(b, width)
    out = torch.empty_like(seqs)
    for c0 in range(0, n, CHUNK):
        vals = seqs[:, c0 : c0 + CHUNK]
        pos = torch.arange(c0, c0 + vals.shape[1], device=dev, dtype=torch.int32)
        onehot = vals[:, :, None] == sym
        occ = torch.where(onehot, pos[None, :, None], _NEG)
        inc = torch.cummax(occ, dim=1).values
        excl = torch.cat([torch.full_like(inc[:, :1], _NEG), inc[:, :-1]], dim=1)
        last = torch.maximum(excl, carry[:, None, :])
        own = torch.where(onehot, last, _NEG).amax(dim=2, keepdim=True)
        out[:, c0 : c0 + CHUNK] = (last > own).sum(dim=2, dtype=torch.int32)
        carry = torch.maximum(carry, inc[:, -1])
    return out


def mtf_ranks_wide_batch(seqs: torch.Tensor, width: int = 256) -> torch.Tensor:
    """Batched wide-alphabet MTF ranks: int32[B, n_max] (values <
    ``width``, 128 or 256) -> int32[B, n_max].

    On a CUDA tensor this launches the kernel (``n_max`` must be a
    multiple of 1024) on the current stream; on a CPU tensor it runs
    ``mtf_ranks_wide_reference``."""
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width}")
    if seqs.dtype != torch.int32 or seqs.dim() != 2:
        raise TypeError(f"expected int32[B, n_max], got {seqs.dtype} {tuple(seqs.shape)}")
    if seqs.device.type == "cpu":
        return mtf_ranks_wide_reference(seqs, width)
    if seqs.device.type != "cuda":
        raise ValueError(f"unsupported device {seqs.device}")
    if not seqs.is_contiguous():
        raise ValueError("seqs must be contiguous")
    b, n_max = seqs.shape
    if n_max % CHUNK:
        raise ValueError(f"n_max must be a multiple of {CHUNK}, got {n_max}")
    if n_max > MAX_N:  # the kernel packs a position and a symbol in 31 bits
        raise ValueError(f"n_max must be at most {MAX_N}, got {n_max}")
    if seqs.data_ptr() % 16:
        raise ValueError("seqs must be 16-byte aligned")
    out = torch.empty_like(seqs)
    if b == 0:
        return out
    launch(seqs, out, width, "mtf_wide")
    count_launch(sys.modules[__name__], width)
    return out


def launch(seqs: torch.Tensor, out: torch.Tensor, width: int, name: str) -> None:
    """Launch the windowed kernel on ``seqs``' current stream, writing
    ``out``.  The caller has checked the input (int32[B, n_max] on a CUDA
    device, contiguous, 16-byte aligned, B > 0, ``n_max`` a multiple of
    1024 and at most ``MAX_N``) and counts the launch; ``name`` is its
    own, for the error message.  Widths 32 and 64 are
    ``mtf_ranks_narrow_batch``'s."""
    b, n_max = seqs.shape
    n_chunks = n_max // CHUNK
    tables = torch.empty((b, n_chunks, width), dtype=torch.int32, device=seqs.device)
    lib = _lib()
    with torch.cuda.device(seqs.device):
        stream = torch.cuda.current_stream(seqs.device).cuda_stream
        err = lib.s3t_mtf_wide(
            seqs.data_ptr(), out.data_ptr(), tables.data_ptr(),
            b, n_chunks, width, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.s3t_mtf_wide_error_string(err).decode()})"
        )


def mtf_ranks_wide(seq: torch.Tensor) -> torch.Tensor:
    """One row at width 256, the counterpart of ``mtf_ranks_pallas``:
    int32[n_max] -> int32[n_max], the batched kernel at B = 1."""
    if seq.dim() != 1:
        raise TypeError(f"expected int32[n_max], got {seq.dtype} {tuple(seq.shape)}")
    return mtf_ranks_wide_batch(seq[None, :], 256)[0]


def mtf_ranks_wide_host(seq_np: np.ndarray, device="cuda") -> np.ndarray:
    """Host wrapper, the counterpart of ``mtf_ranks_pallas_host(seq)``
    and ``mtf_ranks_jax(seq, n_sym)`` (whose ``n_sym`` is unused): one
    row of symbols below 256, padded to a multiple of ``CHUNK`` (1024, as
    the Pallas host wrapper; ``mtf_ranks_jax`` pads to 512), through
    ``mtf_ranks_wide`` on ``device``; returns its ``n`` ranks."""
    n = seq_np.size
    padded = np.zeros(-(-n // CHUNK) * CHUNK, dtype=np.int32)
    padded[:n] = seq_np
    return mtf_ranks_wide(torch.from_numpy(padded).to(device))[:n].cpu().numpy()


_LIB = None


def _lib():
    """The kernel library, built from ``csrc/mtf_wide.cu`` at first use."""
    global _LIB
    if _LIB is None:
        from starch3_tpu_torch._build import build

        lib = ctypes.CDLL(str(build("mtf_wide")))
        lib.s3t_mtf_wide.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.s3t_mtf_wide.restype = ctypes.c_int
        lib.s3t_mtf_wide_error_string.argtypes = [ctypes.c_int]
        lib.s3t_mtf_wide_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
