"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA card.  On a machine with one, from the root of
the repository (this file imports no JAX, so it runs without the JAX
package's test configuration):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel must equal its plain PyTorch version exactly, count one
launch per call, fill every position of its output even as the first
launch of a process, and refuse what it does not take; the device steps on
the card must equal the same steps on the CPU, and the driver must
survive a stalled stream.  The device Huffman ops (``ops/huff.py``,
``ops/bitpack.py``) on the card must equal their CPU results, and a
``device_huffman`` encode of every class must equal libbz2 -9.  The
decode step on the card must equal the CPU, and a device decode of
multi-block streams must equal ``bz2.decompress``.  The exact modes' BWT
and steps on the card must equal the CPU, and an encode in each exact
mode must equal libbz2 -9.  The fast step replayed as its CUDA graph must
equal the eager step and the CPU for every class, keep two batches in
flight apart, count the launches an eager batch counts, and replay one
graph per entry of a mesh, each entry keeping its graphs past four keys."""

import bz2

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
    before, by_width = mtf_wide.launches, dict(mtf_wide.width_launches)
    got = mtf_ranks_wide_batch(seqs, width)
    torch.cuda.synchronize()
    assert mtf_wide.launches == before + 1
    by_width[width] += 1
    assert mtf_wide.width_launches == by_width
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


def test_exact_mode_abandons_a_stalled_stream(cuda):
    """chip_smoke.py's phase 10 (e) at a small size: a device-only ``ranks``
    encode whose first batch is stalled abandons it, its dispatches stay
    short (the launcher thread waits, not the driver), bytes exact."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from starch3_tpu_torch import corpus

    texts = chip_smoke.texts_of(corpus.make_bed(corpus.GENOME_CHROMS[:12], 3_000, seed=3))
    chip_smoke.phase_exact_fault(cuda, texts, torch.cuda.get_device_name(0), stall_s=2.0)


@pytest.mark.parametrize("phase", ["phase_faults", "phase_exact_fault"])
def test_stalled_stream_in_a_fresh_process(cuda, phase):
    """The two tests above, each in a fresh process: a cold CUDA context
    and a cold caching host allocator.  There a page-locked allocation or
    a first launch on the driver's thread waited out the whole stall, so
    no batch could be abandoned in time (ROADMAP C2); every dispatch must
    stay below ``_ABANDON_S``."""
    code = ("import torch, chip_smoke\n"
            "from starch3_tpu_torch import corpus\n"
            "texts = chip_smoke.texts_of(corpus.make_bed(corpus.GENOME_CHROMS[:12], 3_000, seed=3))\n"
            f"chip_smoke.{phase}(torch.device('cuda'), texts, torch.cuda.get_device_name(0), stall_s=2.0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def _huff_inputs(n_max: int, seed: int):
    """Symbol streams, counts, tables and selectors of a batch of three,
    one row empty, one full, one part-filled with symbols past 257."""
    from starch3_tpu_torch.ops import huff

    gen = torch.Generator().manual_seed(seed)
    syms = torch.randint(0, 40, (3, n_max + 2), generator=gen, dtype=torch.int32)
    syms[2, ::9] = 300
    m = torch.tensor([0, n_max + 2, n_max // 3], dtype=torch.int32)
    lens = torch.randint(1, 18, (3, 6, huff.ALPHA_MAX), generator=gen, dtype=torch.int32)
    lens[1, 3:] = lens[1, 0]  # tied tables
    masks = torch.ones((3, 6), dtype=torch.bool)
    masks[0, 2:] = False
    codes = torch.randint(0, 1 << 17, (3, 6 * huff.ALPHA_MAX), generator=gen) & ((1 << lens.reshape(3, -1)) - 1)
    lut = ((codes << 5) | lens.reshape(3, -1)).to(torch.int32)
    return syms, m, lens, masks, lut


@pytest.mark.parametrize("n_max", [16_384, 901_120])
def test_huff_ops_equal_cpu(cuda, n_max):
    """Group histograms, cost/select, the emit (below and above its
    capacity) and the field packer on the card equal their CPU results."""
    from starch3_tpu_torch.ops import bitpack, huff

    syms, m, lens, masks, lut = _huff_inputs(n_max, 7)
    hist = huff.group_hist_padded(syms, m, n_max)
    hist_d = huff.group_hist_padded(syms.to(cuda), m.to(cuda), n_max)
    assert torch.equal(hist_d.cpu(), hist)
    sel, rfreq = huff.cost_and_select(hist, lens, masks)
    sel_d, rfreq_d = huff.cost_and_select(hist_d, lens.to(cuda), masks.to(cuda))
    assert torch.equal(sel_d.cpu(), sel) and torch.equal(rfreq_d.cpu(), rfreq)
    w_cap = pipeline._emit_w_cap(n_max)
    words, totals = bitpack.emit_coded_padded(syms, m, sel, lut, n_max, w_cap)
    words_d, totals_d = bitpack.emit_coded_padded(
        syms.to(cuda), m.to(cuda), sel_d, lut.to(cuda), n_max, w_cap
    )
    assert torch.equal(totals_d.cpu(), totals) and int(totals[1]) > 32 * w_cap
    assert words_d.dtype == torch.uint32
    assert (words_d.cpu().numpy() == words.numpy()).all()
    nbits = torch.randint(0, 33, (5000,), generator=torch.Generator().manual_seed(3))
    vals = torch.randint(0, 1 << 32, (5000,), generator=torch.Generator().manual_seed(4)) & ((1 << nbits) - 1)
    w, t = bitpack.pack_bits_device(vals, nbits, 4000)
    w_d, t_d = bitpack.pack_bits_device(vals.to(cuda), nbits.to(cuda), 4000)
    assert int(t_d) == int(t) and (w_d.cpu().numpy() == w.numpy()).all()


@pytest.mark.parametrize("bits", [4, 8])
def test_step_fast2_equals_cpu(cuda, bits):
    """``fast_huff``'s step on the card (K3 at width 128 for bits 4, 256
    for bits 8) against the CPU, on random tie-free rows and a short row."""
    gen = torch.Generator().manual_seed(bits + 40)
    n_max = 16_384
    syms = torch.randint(0, 16 if bits == 4 else 200, (3, n_max), generator=gen).to(torch.uint8)
    lens = torch.tensor([n_max, 9_000, 1], dtype=torch.int32)
    nsyms = torch.tensor([16 if bits == 4 else 200] * 2 + [1], dtype=torch.int32)
    seqs = syms[:, 0::2] | (syms[:, 1::2] << 4) if bits == 4 else syms
    before = dict(mtf_wide.width_launches)
    got = pipeline.step_fast2(seqs.to(cuda), lens.to(cuda), nsyms.to(cuda), bits)
    torch.cuda.synchronize()
    before[128 if bits == 4 else 256] += 1
    assert mtf_wide.width_launches == before
    for g, w in zip(got, pipeline.step_fast2(seqs, lens, nsyms, bits)):
        assert torch.equal(g.cpu(), w)


def test_device_huffman_encode_every_class(cuda):
    """One device-only ``device_huffman`` encode with blocks of every class,
    a tied block and one whose coded bits overflow the emit: every stream
    equals libbz2 -9, K3 ran at width 128 once per bits-4 batch and at 256
    once per other batch, and the narrow kernels never ran."""
    import numpy as np

    rng = np.random.default_rng(8)
    texts = [
        bytes(rng.integers(0, 16, 12_000, dtype=np.uint8)),
        bytes(rng.integers(0, 24, 6_000, dtype=np.uint8)),
        bytes(rng.integers(0, 50, 7_000, dtype=np.uint8)),
        bytes(rng.integers(0, 200, 9_000, dtype=np.uint8)),
        b"1723\n481\np100\n" * 1000,
        bytes(rng.integers(0, 256, 16_000, dtype=np.uint8)),
    ]
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    narrow, by_width = mtf_narrow.launches, dict(mtf_wide.width_launches)
    got = pipeline.encode_streams(texts, device=cuda, host_assist=False, device_huffman=True)
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    stats = pipeline.device_stats
    assert stats["blocks"] == 6
    assert all(stats[f"blocks_bits{c}"] for c in pipeline.CLASSES)
    assert stats["tie_reencodes"] == 1 and stats["huff_host_reencodes"] == 1
    assert mtf_narrow.launches == narrow
    assert mtf_wide.width_launches[128] - by_width[128] == stats["batches_bits4"]
    assert mtf_wide.width_launches[256] - by_width[256] == stats["batches"] - stats["batches_bits4"]


def test_device_huffman_finishers_reuse_their_streams(cuda, monkeypatch):
    """Twelve ``device_huffman`` batches, twice: each finisher takes a CUDA
    stream from the idle ones and gives it back, so no more streams are
    made than finishers run at once (the pool's 2), and the second encode
    reserves no more device memory than the first.  A fresh stream a batch
    kept each stream's freed blocks in the caching allocator: at 1.1e9
    bytes of BED ``max_memory_reserved`` grew x9.6 from half the corpus to
    all of it."""
    import numpy as np

    rng = np.random.default_rng(9)
    texts = [bytes(rng.integers(0, 16, 100_000, dtype=np.uint8)) for _ in range(36)]
    want = [bz2.compress(t, 9) for t in texts]
    monkeypatch.setattr(pipeline, "_finisher_streams", {})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = []
    for _ in range(2):
        got = pipeline.encode_streams(texts, device=cuda, host_assist=False, device_huffman=True)
        assert [g.data for g in got] == want
        reserved.append(torch.cuda.max_memory_reserved())
    assert 1 <= len(pipeline._finisher_streams[torch.cuda.current_device()]) <= 2
    assert reserved[1] == reserved[0]


def _decode_metas(texts, level: int):
    """The host walk's blocks of ``texts`` compressed at ``level``."""
    return [m for t in texts for m in pipeline.read_stream_blocks(bz2.compress(t, level))[0]]


def test_step_decode_equals_cpu(cuda):
    """The decode step on the card equals the CPU on one batch of real
    blocks at 901,120 (config-3 style BED, three full level-9 blocks)."""
    from starch3_tpu_torch import api, corpus
    from starch3_tpu_torch.parallel import host

    texts = [tf.text for tf in api._parse_transform(corpus.config3_bed(seed=3, n_per=40_000))]
    metas = [m for m in _decode_metas(texts[:3], 9) if host._bucket_for(m[4]) == 901_120]
    assert len(metas) == 3
    args = pipeline.pack_decode_batch(metas, 901_120)
    got_b, got_n = pipeline.step_decode(*(a.to(cuda) for a in args), 901_120)
    want_b, want_n = pipeline.step_decode(*args, 901_120)
    assert torch.equal(got_n.cpu(), want_n) and got_n.tolist() == [m[4] for m in metas]
    assert torch.equal(got_b.cpu(), want_b)


def test_decode_streams_on_card_equals_bz2(cuda):
    """``decode_streams(device="cuda")`` on a level-1 multi-block stream
    and a level-9 one equals ``bz2.decompress``; every block ran on the
    card."""
    from starch3_tpu_torch import corpus

    bed = corpus.wide8_bed(seed=5, chroms=("chr1",), n_per=12_000)
    streams = [bz2.compress(bed, 1), bz2.compress(bed[:50_000], 9)]
    before = dict(pipeline.device_stats)
    got = pipeline.decode_streams(streams, device="cuda")
    assert got == [bz2.decompress(s) for s in streams]
    n_blocks = sum(len(pipeline.read_stream_blocks(s)[0]) for s in streams)
    assert n_blocks >= 4
    assert pipeline.device_stats["decode_blocks"] - before["decode_blocks"] == n_blocks


EXACT_N_MAX = 131_072


def _exact_blocks():
    """Raw blocks at 131,072: a full-length BED6 block (class 5), a
    shorter free-text one (bits 8) and an exactly periodic one."""
    from starch3_tpu_torch import api, corpus

    bed6 = api._parse_transform(corpus.config3_bed(seed=3, n_per=4_000))[0].text
    wide = api._parse_transform(corpus.wide8_bed(seed=5, chroms=("chr1",), n_per=2_000))[0].text
    return [bed6[:EXACT_N_MAX], wide[:90_000], b"1723\n481\np100\n" * 5_000]


def test_exact_bwt_equals_cpu(cuda):
    """``bwt_encode_padded`` on the card equals the CPU at (3, 131,072),
    a periodic row included, and the host sort on each row."""
    from starch3_tpu_torch.codec.bwt import bwt_encode
    from starch3_tpu_torch.ops.bwt import bwt_encode_padded

    datas = _exact_blocks()
    blocks, lens = pipeline.raw_batch(datas, EXACT_N_MAX)
    lens = torch.from_numpy(lens)
    got_last, got_ptr = bwt_encode_padded(blocks.to(cuda), lens.to(cuda))
    want_last, want_ptr = bwt_encode_padded(blocks, lens)
    assert torch.equal(got_last.cpu(), want_last) and torch.equal(got_ptr.cpu(), want_ptr)
    import numpy as np

    for i, data in enumerate(datas):
        h_last, h_ptr = bwt_encode(np.frombuffer(data, np.uint8))
        assert got_last[i, : len(data)].cpu().numpy().tobytes() == h_last.tobytes()
        assert int(got_ptr[i]) == h_ptr


@pytest.mark.parametrize("step", ["step_exact", "step_exact_rle2"])
def test_exact_steps_equal_cpu(cuda, step):
    """The exact modes' steps: rows on the card equal the CPU's, and K3
    launched once, at width 256."""
    fn = getattr(pipeline, step)
    blocks, lens = pipeline.raw_batch(_exact_blocks(), EXACT_N_MAX)
    lens = torch.from_numpy(lens)
    before = dict(mtf_wide.width_launches)
    got = fn(blocks.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    before[256] += 1
    assert mtf_wide.width_launches == before
    assert torch.equal(got.cpu(), fn(blocks, lens))


@pytest.mark.parametrize("device_rle2", [False, True])
def test_exact_mode_encode_equals_bz2(cuda, device_rle2):
    """One device-only encode per exact mode, blocks of every class at
    level 1 (multi-block): libbz2 -1's bytes, K3 at width 256 once per
    batch, the narrow kernel never, no re-encode."""
    import numpy as np

    rng = np.random.default_rng(9)
    texts = [
        bytes(rng.integers(0, 16, 230_000, dtype=np.uint8)),
        bytes(rng.integers(0, 40, 60_000, dtype=np.uint8)),
        bytes(rng.integers(0, 200, 9_000, dtype=np.uint8)),
    ]
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    narrow, by_width = mtf_narrow.launches, dict(mtf_wide.width_launches)
    got = pipeline.encode_streams(texts, level=1, device=cuda, host_assist=False, fast_bwt=False,
                                  device_rle2=device_rle2)
    assert [g.data for g in got] == [bz2.compress(t, 1) for t in texts]
    stats = pipeline.device_stats
    assert stats["blocks"] == 5 and stats["tie_reencodes"] == 0
    assert mtf_narrow.launches == narrow
    assert mtf_wide.width_launches[256] - by_width[256] == stats["batches"]
    assert mtf_wide.width_launches[128] == by_width[128]


def test_two_entry_mesh_on_one_card_equals_bz2(cuda):
    """A mesh that names ``cuda:0`` twice (two entries on two streams of
    one card): a device-only encode with blocks of every class equals
    libbz2 -9, each batch's MTF kernel launched once per entry, and the
    streams decode back under the same mesh."""
    import numpy as np

    from starch3_tpu_torch.parallel.mesh import make_block_mesh

    rng = np.random.default_rng(11)
    texts = [bytes(rng.integers(0, 16, 12_000, dtype=np.uint8)) for _ in range(4)] + [
        bytes(rng.integers(0, hi, 7_000, dtype=np.uint8)) for hi in (24, 50, 200)
    ]
    mesh = make_block_mesh(devices=["cuda:0", "cuda:0"])
    assert mesh.size == 2 and mesh.streams[0] != mesh.streams[1]
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    narrow, by_width = dict(mtf_narrow.width_launches), dict(mtf_wide.width_launches)
    got = pipeline.encode_streams(texts, mesh=mesh, host_assist=False)
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    stats = pipeline.device_stats
    assert stats["blocks"] == len(texts)
    for width, bits in ((16, 4), (32, 5), (64, 6)):
        assert mtf_narrow.width_launches[width] - narrow[width] == 2 * stats[f"batches_bits{bits}"]
    assert mtf_wide.width_launches[256] - by_width[256] == 2 * stats["batches_bits8"]
    assert pipeline.decode_streams([g.data for g in got], mesh=mesh) == texts


def _fast_batch(bits: int, n_max: int, seed: int):
    """A random batch of three rows of class ``bits`` in the upload format
    of its fast step (``pack_batch``'s), one row shorter, one of length 1."""
    gen = torch.Generator().manual_seed(seed)
    hi = 200 if bits == 8 else 1 << bits
    syms = torch.randint(0, hi, (3, n_max), generator=gen)
    if bits == 4:
        packed = (syms[:, 0::2] | (syms[:, 1::2] << 4)).to(torch.uint8)
    elif bits in (5, 6):
        packed = pipeline._pack_words(syms, 30 // bits, bits).to(torch.int32)
    else:
        packed = syms.to(torch.uint8)
    lens = torch.tensor([n_max, n_max - 12_345, 1], dtype=torch.int32)
    return packed, lens, torch.tensor([hi, hi, 1], dtype=torch.int32)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("n_max", [458_752, 901_120])
@pytest.mark.parametrize("bits", [4, 5, 6, 8])
def test_replayed_rows_equal_eager_and_cpu(cuda, bits, n_max):
    """The fast step of each class through the launcher as its CUDA graph
    (``pipeline._StepGraph``): two batches of different data, each twice,
    after the key's warm-up and capture, equal the same batches launched
    eagerly and the step on the CPU."""
    cs = _chip_smoke()
    batches = [_fast_batch(bits, n_max, seed) for seed in (1, 2)]
    want = [pipeline.step_for_class(*x, bits, n_max) for x in batches]
    eager = [cs.launched_rows(cuda, x, bits, n_max, graphed=False) for x in batches]
    replays = pipeline.device_stats["graph_replays"]
    got = [cs.launched_rows(cuda, batches[k % 2], bits, n_max, graphed=True) for k in range(6)]
    assert pipeline.device_stats["graph_replays"] - replays >= 4
    assert any(where[2] == bits and key[0] == n_max for where, graphs in pipeline._STEP_GRAPHS.items() for key in graphs)
    for k, rows in enumerate(got):
        assert torch.equal(rows, want[k % 2]) and torch.equal(rows, eager[k % 2])


def test_two_replays_in_flight_stay_apart(cuda):
    """Batches launched back to back without a wait share the graph's
    static inputs and rows: each copies its rows out on the stream before
    the next replay overwrites them, so every batch keeps its own."""
    bits, n_max = 4, 458_752
    cs = _chip_smoke()
    batches = [_fast_batch(bits, n_max, seed) for seed in (3, 4, 5)]
    want = [pipeline.step_for_class(*x, bits, n_max) for x in batches]
    for x in batches[:2]:  # the key's warm-up and capture
        cs.launched_rows(cuda, x, bits, n_max, graphed=True)

    def step(*args):
        return pipeline.step_for_class(*args, bits, n_max), ()

    replays = pipeline.device_stats["graph_replays"]
    order = [0, 1, 2, 1, 0, 2, 2, 0]
    launched = [pipeline._launch(cuda, batches[i], step, (bits, n_max)) for i in order]
    for i, one in zip(order, launched):
        one.synchronize()
        assert torch.equal(one.future.result()[0], want[i])
    assert pipeline.device_stats["graph_replays"] - replays == len(order)


@pytest.mark.parametrize("bits", [4, 5, 6, 8])
def test_replays_count_the_launches_of_eager_batches(cuda, bits):
    """The MTF launch counters, by width, after three eager batches and
    after three through the graph (warm-up or replay): the same counts,
    though a replay runs no Python of the wrappers."""
    n_max = 458_752
    cs = _chip_smoke()
    batch = _fast_batch(bits, n_max, 6)
    deltas = []
    for graphed in (False, True):
        before = cs.launch_counts()
        for _ in range(3):
            cs.launched_rows(cuda, batch, bits, n_max, graphed=graphed)
        deltas.append(cs.count_delta(before, cs.launch_counts()))
    width = {4: "narrow16", 5: "narrow32", 6: "narrow64", 8: "wide256"}[bits]
    assert deltas[0] == deltas[1] == {width: 3}


def test_two_entry_mesh_replays_a_graph_per_entry(cuda):
    """A mesh that names ``cuda:0`` twice, device only, with enough bits-4
    batches that each entry's stream replays its own graph: bytes equal
    libbz2 -9, one capture per entry, and the MTF kernel counted once per
    entry per batch."""
    import numpy as np

    from starch3_tpu_torch.parallel.mesh import make_block_mesh

    rng = np.random.default_rng(12)
    texts = [bytes(rng.integers(0, 16, 20_000, dtype=np.uint8)) for _ in range(15)]
    mesh = make_block_mesh(devices=["cuda:0", "cuda:0"])
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    narrow = dict(mtf_narrow.width_launches)
    got = pipeline.encode_streams(texts, mesh=mesh, host_assist=False)
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    stats = pipeline.device_stats
    assert stats["blocks"] == len(texts) and stats["batches"] >= 5
    # at most one capture per entry (a pooled stream may already hold its key)
    assert stats["graph_captures"] <= 2 and stats["graph_replays"] >= 2 * 3
    assert mtf_narrow.width_launches[16] - narrow[16] == 2 * stats["batches"]
    streams = {where[1] for where, graphs in pipeline._STEP_GRAPHS.items() if graphs}
    assert {s.cuda_stream for s in mesh.streams} <= streams


def test_graphs_past_the_cache_bound_capture_again(cuda):
    """More keys of one class than the graph cache holds for a stream
    (``_STEP_GRAPHS_MAX``), on the default stream and on a stream of their
    own: the least recently used graphs are dropped, with their pool once
    no live graph shares it, and a dropped key seen again is captured
    anew at once, without a second warm-up, and rated (its batch is not
    ``first_of_key``); rows equal the CPU's.  The n_max is no encode's
    bucket, so no other test has warmed these keys."""
    bits, n_max = 4, 20_480
    side = torch.cuda.Stream()
    keys = [(b_pad, stream) for stream in (None, side) for b_pad in range(1, pipeline._STEP_GRAPHS_MAX + 2)]

    def batch_of(b_pad):
        packed, lens, nsyms = _fast_batch(bits, n_max, b_pad)
        return packed[:1].repeat(b_pad, 1), lens[:1].repeat(b_pad), nsyms[:1].repeat(b_pad)

    def step(*args):
        return pipeline.step_for_class(*args, bits, n_max), ()

    def launched(batch, stream):
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            one = pipeline._launch(cuda, batch, step, (bits, n_max))
        one.synchronize()
        assert torch.equal(one.future.result()[0], pipeline.step_for_class(*batch, bits, n_max))
        return one

    for b_pad, stream in keys:
        batch = batch_of(b_pad)
        # warm-up, first capture and replay, replay
        assert [launched(batch, stream).first_of_key for _ in range(3)] == [True, True, False]
    for stream in (torch.cuda.current_stream(), side):
        assert len(pipeline._STEP_GRAPHS[(cuda.index or 0, stream.cuda_stream, bits)]) == pipeline._STEP_GRAPHS_MAX
    b_pad, stream = keys[0]  # the least recently used: dropped
    captures, replays = pipeline.device_stats["graph_captures"], pipeline.device_stats["graph_replays"]
    assert not launched(batch_of(b_pad), stream).first_of_key
    assert pipeline.device_stats["graph_captures"] == captures + 1
    assert pipeline.device_stats["graph_replays"] == replays + 1


def test_mesh_entries_keep_their_graphs_past_four_keys_each(cuda):
    """A mesh that names ``cuda:0`` twice, each entry launching batches of
    six keys in turns (three classes at two n_max), four rounds: the graph
    cache is bounded per card, stream and class, so no key drops another
    entry's graph or its own: each key warms up and captures once per
    entry, then replays, so the replays outnumber the captures three to
    one, and each entry's stream holds every key's graph at the end (no
    other test uses these n_max).  Rows equal the CPU's."""
    from starch3_tpu_torch.parallel.mesh import make_block_mesh, on_entry

    mesh = make_block_mesh(devices=["cuda:0", "cuda:0"])
    keys = [(bits, n_max) for bits in (4, 5, 8) for n_max in (32_768, 65_536)]
    batches = {key: _fast_batch(*key, 7) for key in keys}
    wants = {key: pipeline.step_for_class(*batches[key], *key) for key in keys}

    def step_of(bits, n_max):
        return lambda *args: (pipeline.step_for_class(*args, bits, n_max), ())

    stats = dict(pipeline.device_stats)
    for _ in range(4):
        for key in keys:
            launched = []
            for dev, stream in zip(mesh.devices, mesh.streams):
                with on_entry(dev, stream):
                    launched.append(pipeline._launch(dev, batches[key], step_of(*key), key))
            for one in launched:
                one.synchronize()
                assert torch.equal(one.future.result()[0], wants[key])
    captures = pipeline.device_stats["graph_captures"] - stats["graph_captures"]
    replays = pipeline.device_stats["graph_replays"] - stats["graph_replays"]
    assert captures == mesh.size * len(keys) and replays == 3 * captures
    for stream in mesh.streams:
        for bits, n_max in keys:
            shapes = tuple(tuple(t.shape) for t in batches[(bits, n_max)])
            assert (n_max, *shapes) in pipeline._STEP_GRAPHS[(0, stream.cuda_stream, bits)]
