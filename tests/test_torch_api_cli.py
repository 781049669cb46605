"""The port's entry points (starch3_tpu_torch/api.py, cli.py) on the CPU
device: archive bytes equal to the JAX package's device path (on the
CPU) and to its host path; no silent fallback without a card; no JAX."""

import io
import subprocess
import sys

import pytest
import torch

from starch3_tpu import api as jax_api
from starch3_tpu.config import EncodeConfig as JaxEncodeConfig
from starch3_tpu_torch import api
from starch3_tpu_torch.config import EncodeConfig

from tests.conftest import make_bed_text

torch.set_num_threads(2)

CLI = [sys.executable, "-m", "starch3_tpu_torch.cli"]


def run(args, input_=b""):
    return subprocess.run(CLI + args, input=input_, capture_output=True)


@pytest.fixture
def bed(rng):
    return make_bed_text(rng, n=6000, chroms=("chr1", "chr2", "chrM"))


@pytest.fixture
def host_archive(bed):
    return jax_api.compress_bed_bytes(bed, JaxEncodeConfig())


def test_bytes_equal_jax_device_and_host(bed, host_archive):
    got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=True), device="cpu")
    assert got == host_archive
    assert got == jax_api.compress_bed_bytes(bed, JaxEncodeConfig(use_jax=True))
    assert api.decompress_starch_bytes(got) == bed


def test_single_stream_helpers_equal_host(rng):
    text = jax_api._parse_transform(make_bed_text(rng, n=900))[0].text
    cfg = EncodeConfig(use_jax=True)
    assert api._compress_stream(text, cfg, device="cpu") == jax_api._compress_stream(
        text, JaxEncodeConfig()
    )
    got = api._compress_stream_ex(text, cfg, device="cpu")
    assert got == jax_api._compress_stream_ex(text, JaxEncodeConfig())


def test_stream_and_file_equal_host(bed, host_archive, tmp_path):
    """Small chunks make chromosomes span chunk boundaries (the carry)."""
    out = io.BytesIO()
    api.compress_bed_stream(
        io.BytesIO(bed), out, EncodeConfig(use_jax=True), chunk_bytes=4096, device="cpu"
    )
    assert out.getvalue() == host_archive
    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    out = io.BytesIO()
    api.compress_bed_file(str(src), out, EncodeConfig(use_jax=True), device="cpu")
    assert out.getvalue() == host_archive


def test_config3_shaped_archive_equals_host():
    """BED6 with remainder columns (config 3's shape: bits 5 blocks) and
    a chromosome of free-text names (bits 8) through the device path."""
    from starch3_tpu_torch import corpus

    bed = corpus.config3_bed(n_per=400)
    bed += corpus.wide8_bed(seed=4, chroms=("chrZ",), n_per=300)
    want = jax_api.compress_bed_bytes(bed, JaxEncodeConfig())
    got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=True), device="cpu")
    assert got == want
    assert api.decompress_starch_bytes(got) == bed


def test_no_final_newline_and_duplicate_chromosome(rng):
    from starch3_tpu_torch.errors import BedParseError

    bed = make_bed_text(rng, n=600)[:-1]
    got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=True), device="cpu")
    assert got == jax_api.compress_bed_bytes(bed, JaxEncodeConfig())
    assert api.decompress_starch_bytes(got) == bed
    dup = b"chr1\t10\t20\nchr2\t5\t9\nchr1\t30\t40\n"
    with pytest.raises(BedParseError):
        api.compress_bed_bytes(dup, EncodeConfig(use_jax=True), device="cpu")


def _device_only(monkeypatch):
    """Start no host stealer, so that every block goes to the device; and
    record each encode's mode and each wide MTF call's width."""
    from starch3_tpu_torch.parallel import pipeline

    seen = {"modes": [], "wide_widths": []}
    driver, wide = pipeline._device_driver, pipeline.mtf_ranks_wide_batch

    def spy_driver(*args):
        seen["modes"].append(args[6])  # (q, results, errors, device, batch_size, reserve, mode, huff)
        return driver(*args)

    def spy_wide(seqs, width=256):
        seen["wide_widths"].append(width)
        return wide(seqs, width)

    monkeypatch.setattr(pipeline, "_start_host_stealers", lambda *args: [])
    monkeypatch.setattr(pipeline, "_device_driver", spy_driver)
    monkeypatch.setattr(pipeline, "mtf_ranks_wide_batch", spy_wide)
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    return seen, pipeline.device_stats


def test_device_rle2_with_fast_bwt_runs_fast_mode(bed, host_archive, monkeypatch):
    """``device_rle2=True`` with the default ``fast_bwt`` is fast mode, as
    in the reference: the JAX package's bytes, the bits-4 class counters
    move, the rows read back are fast mode's ``[ptr, ties, nibbles]``, and
    the wide MTF never runs at width 256 on a bits-4 block."""
    seen, stats = _device_only(monkeypatch)
    got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=True, device_rle2=True), device="cpu")
    assert got == jax_api.compress_bed_bytes(bed, JaxEncodeConfig(use_jax=True, device_rle2=True))
    assert got == host_archive
    assert seen["modes"] == ["fast"] and 256 not in seen["wide_widths"]
    assert stats["blocks_bits4"] == stats["blocks"] == 3 and stats["batches_bits4"] == 1
    assert stats["d2h_bytes_bits4"] == 3 * (2 + 131_072 // 8) * 4


@pytest.mark.parametrize("device_rle2", [False, True])
def test_exact_mode_archives_equal_host(bed, host_archive, monkeypatch, device_rle2):
    """``fast_bwt=False``, with and without ``device_rle2``, through
    ``compress_bed_bytes`` and ``compress_bed_stream``: the host path's
    archive, every block on the device at width 256."""
    seen, stats = _device_only(monkeypatch)
    cfg = EncodeConfig(use_jax=True, fast_bwt=False, device_rle2=device_rle2)
    assert api.compress_bed_bytes(bed, cfg, device="cpu") == host_archive
    out = io.BytesIO()
    api.compress_bed_stream(io.BytesIO(bed), out, cfg, chunk_bytes=4096, device="cpu")
    assert out.getvalue() == host_archive
    mode = "rle2" if device_rle2 else "ranks"
    assert seen["modes"] == [mode, mode]
    assert stats["blocks"] == 6 and stats["tie_reencodes"] == 0
    assert seen["wide_widths"] == [256] * stats["batches"]


def test_device_huffman_archive_equals_host(bed, host_archive):
    """``device_huffman`` (mode fast_huff) through the archive API."""
    got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=True, device_huffman=True), device="cpu")
    assert got == host_archive
    assert api.decompress_starch_bytes(got) == bed


def test_cli_cpu_platform_same_bytes(bed, host_archive, tmp_path):
    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    r = run(["--platform=cpu", "--jax", str(src)])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == host_archive
    r = run(["--jax", "--platform=cpu"], input_=bed)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == host_archive
    r = run(["--decode"], input_=host_archive)
    assert r.returncode == 0 and r.stdout == bed


def test_cli_device_huffman_same_bytes(bed, host_archive, tmp_path):
    """``--jax --device-huffman`` writes the host path's archive, as the
    reference's CLI does (tests/test_cli.py)."""
    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    r = run(["--jax", "--device-huffman", "--platform=cpu", str(src)])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == host_archive


def test_cli_without_card_exits_nonzero(bed, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    r = run(["--jax", str(src)])
    assert r.returncode != 0
    assert b"--platform=cpu" in r.stderr or b"device='cpu'" in r.stderr
    assert r.stdout == b""


@pytest.mark.parametrize(
    "args,msg",
    [
        (["--num-hosts=2", "--host-id=0"], b"not yet ported"),
        (["--platform=tpu", "--jax"], b"--platform"),
        (["--chrom=chr1"], b"--chrom requires --decode"),
    ],
)
def test_cli_rejects(args, msg, bed):
    r = run(args, input_=bed)
    assert r.returncode != 0
    assert msg in r.stderr


def test_cli_help_and_version():
    r = run(["--help"])
    assert r.returncode == 0 and b"--platform" in r.stdout
    r = run(["-v"])
    assert r.returncode == 0 and b"starch3-tpu-torch" in r.stdout


def test_port_never_imports_jax():
    """A fresh process: every module of the port, a CPU device encode and
    decode, and the host path leave ``jax`` out of ``sys.modules``."""
    code = (
        "import io, sys\n"
        "import starch3_tpu_torch, starch3_tpu_torch.cli, starch3_tpu_torch._build\n"
        "import starch3_tpu_torch.profile_step, starch3_tpu_torch.corpus\n"
        "from starch3_tpu_torch import api\n"
        "bed = b'chr1\\t1\\t5\\nchr1\\t7\\t9\\nchr2\\t3\\t4\\n'\n"
        "a = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=True), device='cpu')\n"
        "assert a == api.compress_bed_bytes(bed, api.EncodeConfig())\n"
        "out = io.BytesIO()\n"
        "api.compress_bed_stream(io.BytesIO(bed), out, api.EncodeConfig(use_jax=True), device='cpu')\n"
        "assert out.getvalue() == a\n"
        "assert api.decompress_starch_bytes(a) == bed\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()
