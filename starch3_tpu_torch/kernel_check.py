"""First launches of the port's MTF kernels on a sentinel-filled output.

From the root of the repository, on a machine with one CUDA card:

    python -m starch3_tpu_torch.kernel_check --case W:N:INPUT [--case ...] [--seed S]

Each case is a width ``W`` (16, 32, 64, 128 or 256), three rows of ``N``
positions, and ``INPUT``: ``random`` (uniform symbols below ``W``) or
``real`` (the MTF input of the width's tier, the BWT of three real blocks
of its corpus, computed on the CPU).  The case calls the kernel's C entry
itself, ``s3t_mtf_narrow16`` at width 16 and ``mtf_wide.launch`` at the
others, on an output filled with ``0x5A5A5A5A``, synchronizes, and counts
the sentinels left and the positions that differ from the plain version
(run on the CPU).  At width 16 it also reads the tile counter
``tables[16 * n_tiles]``, which must end at ``n_tiles``.  Then it calls
the wrapper as the device step does, on an output from
``torch.empty_like``, and compares it with the plain version on the card:
that read is the one ``compute-sanitizer --tool initcheck`` would flag if
the kernel left a position unwritten.

The inputs are made before the first CUDA call, so the first case's launch
is the process's first launch of a port kernel, as in ``chip_smoke.py``'s
first kernel check: run one case per process to test that condition, or a
list of cases under ``compute-sanitizer``.  One JSON object per case on
standard output; the exit code is 1 if any case failed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from starch3_tpu_torch.ops import mtf_narrow, mtf_wide

SENTINEL = 0x5A5A5A5A  # no rank: ranks are at most the width


def make_input(width: int, n: int, kind: str, seed: int) -> torch.Tensor:
    """int32[3, n] on the CPU: uniform random symbols, or the real MTF
    input of the width's tier (``profile_kernels.REAL``)."""
    if kind == "random":
        gen = torch.Generator().manual_seed(seed * 1000 + width)
        return torch.randint(0, width, (3, n), generator=gen, dtype=torch.int32)
    if kind != "real":
        raise ValueError(f"input must be random or real, got {kind}")
    from starch3_tpu_torch.profile_kernels import REAL, corpus_texts, real_mtf_input

    return real_mtf_input(corpus_texts(REAL[width][1], seed), width, n, torch.device("cpu"))


def plain(seqs: torch.Tensor, width: int) -> torch.Tensor:
    if width in mtf_narrow.WIDTHS:
        return mtf_narrow.mtf_ranks_narrow_reference(seqs, width)
    return mtf_wide.mtf_ranks_wide_reference(seqs, width)


def raw_launch(seqs: torch.Tensor, out: torch.Tensor, width: int):
    """The kernel's C entry on ``out``, on the current stream.  Returns
    the width-16 tile counter's tensor (None at other widths)."""
    if width != 16:
        mtf_wide.launch(seqs, out, width, "kernel_check")
        return None
    b, n = seqs.shape
    n_chunks = n // mtf_narrow.CHUNK
    tables = torch.zeros(b * n_chunks * 16 + 1, dtype=torch.int32, device=seqs.device)
    lib = mtf_narrow._lib()
    err = lib.s3t_mtf_narrow16(
        seqs.data_ptr(), out.data_ptr(), tables.data_ptr(), b, n_chunks,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"s3t_mtf_narrow16 failed: CUDA error {err} ({lib.s3t_error_string(err).decode()})")
    return tables


def run_case(seqs_cpu: torch.Tensor, width: int) -> dict:
    """The sentinel launch and the wrapper call of one input (see the
    module's docstring); ``ok`` is the verdict."""
    dev = torch.device("cuda")
    want = plain(seqs_cpu, width)
    seqs = seqs_cpu.to(dev)
    out = torch.full_like(seqs, SENTINEL)
    tables = raw_launch(seqs, out, width)
    torch.cuda.synchronize()
    left = int((out == SENTINEL).sum().item())
    got = out.cpu()
    res = {
        "sentinels_left": left,
        "mismatches": int((got != want).sum()),
        "max_abs_err": int((got.long() - want.long()).abs().max()),
    }
    if tables is not None:
        n_tiles = seqs.shape[0] * (seqs.shape[1] // mtf_narrow.CHUNK)
        res["tiles"] = n_tiles
        res["tile_counter"] = int(tables[-1].item())
    wrapper = mtf_narrow.mtf_ranks_narrow_batch if width in mtf_narrow.WIDTHS else mtf_wide.mtf_ranks_wide_batch
    got_dev = wrapper(seqs, width)
    res["wrapper_max_abs_err"] = int((got_dev.long() - want.to(dev).long()).abs().max().item())
    res["ok"] = (
        left == 0
        and res["mismatches"] == 0
        and res["wrapper_max_abs_err"] == 0
        and res.get("tile_counter") == res.get("tiles")
    )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", action="append", required=True, metavar="W:N:INPUT")
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_check needs a CUDA card")
    cases = []
    for spec in args.case:
        w, n, kind = spec.split(":")
        cases.append((spec, int(w), make_input(int(w), int(n), kind, args.seed)))
    failed = 0
    for spec, width, seqs in cases:
        res = {"case": spec, **run_case(seqs, width)}
        failed += not res["ok"]
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
