"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA card.  On a machine with one, from the root of
the repository (this file imports no JAX, so it runs without the JAX
package's test configuration):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel must equal its plain PyTorch version exactly, count one
launch per call, fill every position of its output even as the first
launch of a process, and refuse what it does not take; the device steps on
the card must equal the same steps on the CPU, and the driver must
survive a stalled stream."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from starch3_tpu_torch.ops import mtf_narrow, mtf_wide
from starch3_tpu_torch.ops.mtf_narrow import (
    mtf_ranks_narrow_batch,
    mtf_ranks_narrow_reference,
)
from starch3_tpu_torch.ops.mtf_wide import (
    mtf_ranks_wide,
    mtf_ranks_wide_batch,
    mtf_ranks_wide_reference,
)
from starch3_tpu_torch.parallel import pipeline

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the production buckets have 112 and 220 chunks a row at width 16: the
# look-back crosses several 32-chunk windows
SHAPES = [(1, 4096), (3, 16_384), (2, 131_072), (3, 458_752), (3, 901_120)]


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_equals_plain(cuda, width, shape):
    gen = torch.Generator().manual_seed(width * 7 + shape[1])
    seqs = torch.randint(0, width, shape, generator=gen, dtype=torch.int32)
    seqs[0, 1] = width - 1
    seqs[-1, -5:] = width + 1  # outside the alphabet: ranks `width`
    seqs = seqs.to(cuda)
    before = mtf_narrow.launches, mtf_narrow.width_launches[width]
    got = mtf_ranks_narrow_batch(seqs, width)
    torch.cuda.synchronize()
    assert (mtf_narrow.launches, mtf_narrow.width_launches[width]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, mtf_ranks_narrow_reference(seqs, width))


@pytest.mark.parametrize("width", [32, 64])
def test_windowed_widths_count_as_narrow_launches(cuda, width):
    """Widths 32/64 run the windowed kernel of csrc/mtf_wide.cu through the
    narrow wrapper: one narrow launch per call, counted at its width and
    not at width 16, none of the wide wrapper's, at the smallest narrow
    shape and at a production one."""
    for shape in [(1, 4096), (3, 901_120)]:
        seqs = torch.randint(0, width, shape, generator=torch.Generator().manual_seed(width),
                             dtype=torch.int32).to(cuda)
        narrow, wide = mtf_narrow.launches, mtf_wide.launches
        by_width = dict(mtf_narrow.width_launches)
        got = mtf_ranks_narrow_batch(seqs, width)
        torch.cuda.synchronize()
        assert (mtf_narrow.launches, mtf_wide.launches) == (narrow + 1, wide)
        by_width[width] += 1
        assert mtf_narrow.width_launches == by_width
        assert torch.equal(got, mtf_ranks_narrow_reference(seqs, width))


@pytest.mark.parametrize("width", [32, 64])
def test_windowed_widths_runs_then_every_symbol(cuda, width):
    """Rows that hold one symbol for whole windows and chunks, then every
    symbol of the alphabet inside one window, then runs again; the last
    row starts with a window of all symbols."""
    n_max = 16_384
    seqs = torch.empty((3, n_max), dtype=torch.int32)
    seqs[0] = 5
    seqs[0, 3000 : 3000 + width] = torch.arange(width, dtype=torch.int32).flip(0)
    seqs[1] = torch.arange(n_max, dtype=torch.int32) // 700 % width
    seqs[1, 2048 : 2048 + width] = torch.randperm(width, generator=torch.Generator().manual_seed(3)).int()
    seqs[2] = torch.arange(n_max, dtype=torch.int32) % width
    seqs[2, 64:] = width - 1
    seqs = seqs.to(cuda)
    got = mtf_ranks_narrow_batch(seqs, width)
    torch.cuda.synchronize()
    assert torch.equal(got, mtf_ranks_narrow_reference(seqs, width))


def test_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError, match="multiple of 4096"):
        mtf_ranks_narrow_batch(torch.zeros((1, 1000), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mtf_ranks_narrow_batch(torch.zeros((8192, 2), dtype=torch.int32, device=cuda).t())


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("shape", [(1, 1024)] + SHAPES[1:])
def test_wide_kernel_equals_plain(cuda, width, shape):
    gen = torch.Generator().manual_seed(width * 11 + shape[1])
    seqs = torch.randint(0, width, shape, generator=gen, dtype=torch.int32)
    seqs[0, 1] = width - 1
    seqs[-1, -5:] = width + 1  # outside the alphabet: ranks `width`
    seqs[0, -3:] = -2  # negative: outside too
    seqs = seqs.to(cuda)
    before = mtf_wide.launches
    got = mtf_ranks_wide_batch(seqs, width)
    torch.cuda.synchronize()
    assert mtf_wide.launches == before + 1
    assert torch.equal(got, mtf_ranks_wide_reference(seqs, width))


def test_wide_kernel_single_row(cuda):
    seq = torch.randint(0, 256, (8192,), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(cuda)
    got = mtf_ranks_wide(seq)
    assert torch.equal(got, mtf_ranks_wide_reference(seq[None, :], 256)[0])


def test_wide_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError, match="multiple of 1024"):
        mtf_ranks_wide_batch(torch.zeros((1, 1000), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mtf_ranks_wide_batch(torch.zeros((2048, 2), dtype=torch.int32, device=cuda).t())


@pytest.mark.parametrize("bits", [5, 6, 8])
def test_tier_steps_equal_cpu(cuda, bits):
    """The mid and bits-8 device steps on the card against the CPU, on a
    random batch with one short row (rows equal where the sort is
    tie-free, which random rows are)."""
    gen = torch.Generator().manual_seed(bits)
    n_max = 16_384
    syms = torch.randint(0, 1 << bits if bits < 8 else 200, (3, n_max), generator=gen)
    lens = torch.tensor([n_max, 9_000, 1], dtype=torch.int32)
    if bits == 8:
        seqs = syms.to(torch.uint8)
        nsyms = torch.tensor([200, 200, 1], dtype=torch.int32)
        want = pipeline.step_fast(seqs, lens, nsyms, 8)
        got = pipeline.step_fast(seqs.to(cuda), lens.to(cuda), nsyms.to(cuda), 8)
    else:
        words = pipeline._pack_words(syms, 30 // bits, bits).to(torch.int32)
        want = pipeline.step_ranks_mid(words, lens, bits, n_max)
        got = pipeline.step_ranks_mid(words.to(cuda), lens.to(cuda), bits, n_max)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", [16, 32, 64, 128, 256])
def test_kernels_equal_plain_on_real_bwt_input(cuda, width):
    """The MTF input the device steps really give each kernel: the BWT of
    three real blocks of the width's tier (a cut of its corpus), where
    most ranks are small and some symbols are absent from whole chunks."""
    from starch3_tpu_torch import api, corpus
    from starch3_tpu_torch.profile_kernels import real_mtf_input

    bed = {
        16: lambda: corpus.make_bed(corpus.GENOME_CHROMS[:4], 3_000, seed=3),
        32: lambda: corpus.config3_bed(n_per=2_000),
        64: lambda: corpus.bits6_bed(n_per=2_000),
        128: lambda: corpus.make_bed(corpus.GENOME_CHROMS[:4], 3_000, seed=3),
        256: lambda: corpus.wide8_bed(seed=3, n_per=2_000),
    }[width]()
    texts = [tf.text for tf in api._parse_transform(bed)]
    seqs = real_mtf_input(texts, width, 131_072, cuda)
    kernel = mtf_ranks_narrow_batch if width <= 64 else mtf_ranks_wide_batch
    plain = mtf_ranks_narrow_reference if width <= 64 else mtf_ranks_wide_reference
    got = kernel(seqs, width)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(seqs, width))


def test_width16_more_blocks_than_fit(cuda):
    """1,792 chunks, more than the card holds at once: blocks wait only on
    chunks that running blocks claimed (the tile counter), so the launch
    finishes and equals the plain version."""
    seqs = torch.randint(0, 16, (16, 458_752), generator=torch.Generator().manual_seed(16),
                         dtype=torch.int32).to(cuda)
    seqs[3, 1000:] = 7  # one long run: later chunks of row 3 lack symbols
    got = mtf_ranks_narrow_batch(seqs, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, mtf_ranks_narrow_reference(seqs, 16))


# width:n_max:input; the real input of each width as chip_smoke.py uses it
SENTINEL_CASES = [
    "16:901120:random", "16:901120:real", "16:458752:random", "16:458752:real",
    "32:901120:random", "32:901120:real", "64:901120:random", "64:901120:real",
    "128:901120:random", "128:901120:real", "256:901120:random", "256:901120:real",
]


@pytest.mark.parametrize("case", SENTINEL_CASES)
def test_first_launch_of_a_process_writes_every_position(cuda, case):
    """In a fresh process, the kernel's first launch writes every position
    of an output filled with a sentinel and equals the plain version; at
    width 16 the tile counter ends at the number of tiles.  Then the
    wrapper, on an uninitialised output, equals it too (``kernel_check``)."""
    proc = subprocess.run(
        [sys.executable, "-m", "starch3_tpu_torch.kernel_check", "--case", case],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["case"] == case
    assert res["sentinels_left"] == 0 and res["mismatches"] == 0 and res["wrapper_max_abs_err"] == 0
    if case.startswith("16:"):
        assert res["tile_counter"] == res["tiles"] == 3 * int(case.split(":")[1]) // 4096


def test_driver_survives_a_stalled_stream(cuda):
    """chip_smoke.py's fault phase at a small size: a stalled first batch
    is abandoned and the device benched in a hybrid and in a device-only
    encode, a clean encode after the stall uses the device again, and the
    no-fallback lane waits the stall out; all bytes exact."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from starch3_tpu_torch import corpus

    texts = chip_smoke.texts_of(corpus.make_bed(corpus.GENOME_CHROMS[:12], 3_000, seed=3))
    chip_smoke.phase_faults(cuda, texts, torch.cuda.get_device_name(0), stall_s=2.0)
