"""The port's entry points (starch3_tpu_torch/api.py, cli.py) on the CPU
device: archive bytes equal to the JAX package's device path (on the
CPU) and to its host path; the device path on the card is the default,
and the host is asked for (``use_jax=False``, ``--platform=host``) or the
plain versions (``device="cpu"``, ``--platform=cpu``); no silent fallback
without a card; no JAX."""

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
    assert api.decompress_starch_bytes(got, use_jax=False) == bed


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
    assert api.decompress_starch_bytes(got, use_jax=False) == bed


def test_no_final_newline_and_duplicate_chromosome(rng):
    from starch3_tpu_torch.errors import BedParseError

    bed = make_bed_text(rng, n=600)[:-1]
    got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=True), device="cpu")
    assert got == jax_api.compress_bed_bytes(bed, JaxEncodeConfig())
    assert api.decompress_starch_bytes(got, use_jax=False) == bed
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
    assert api.decompress_starch_bytes(got, use_jax=False) == bed


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
    """The flagless CLI encodes on the card, and so does ``--jax`` (a
    no-op): without one each exits non-zero, names both ways of asking for
    the CPU, and writes no archive, to stdout or to ``--output``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    for flags in ([], ["--jax"]):
        r = run([*flags, str(src)])
        assert r.returncode != 0
        assert b"--platform=cpu" in r.stderr and b"--platform=host" in r.stderr
        assert r.stdout == b""
    out = tmp_path / "out.starch"
    r = run(["-o", str(out)], input_=bed)
    assert r.returncode != 0 and r.stdout == b""
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.bed"]


def test_default_is_the_device_path():
    assert EncodeConfig().use_jax is True
    assert api.decompress_starch_bytes.__defaults__[1] is True  # use_jax


def _entry(name, bed, archive, tmp_path):
    """Call the entry point ``name`` with its defaults (no config, no
    device, no flag)."""
    from starch3_tpu_torch.parallel.distributed import compress_bed_bytes_multihost

    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    return {
        "compress_bed_bytes": lambda: api.compress_bed_bytes(bed),
        "compress_bed_stream": lambda: api.compress_bed_stream(io.BytesIO(bed), io.BytesIO()),
        "compress_bed_file": lambda: api.compress_bed_file(str(src), io.BytesIO()),
        "compress_bed_bytes_multihost": lambda: compress_bed_bytes_multihost(bed, num_hosts=1, host_id=0),
        "decompress_starch_bytes": lambda: api.decompress_starch_bytes(archive),
        "decompress_starch_bytes_empty": lambda: api.decompress_starch_bytes(
            api.compress_bed_bytes(b"", EncodeConfig(use_jax=False))
        ),
        "compress_bed_bytes_empty": lambda: api.compress_bed_bytes(b""),
    }[name]


@pytest.mark.parametrize(
    "name",
    [
        "compress_bed_bytes",
        "compress_bed_stream",
        "compress_bed_file",
        "compress_bed_bytes_multihost",
        "decompress_starch_bytes",
        "decompress_starch_bytes_empty",
        "compress_bed_bytes_empty",
    ],
)
def test_default_without_card_raises(name, bed, host_archive, tmp_path):
    """No fallback: with no card each default encode and the default
    decode raise ``resolve_device``'s error, whose message names both ways
    of asking for the CPU; an empty input or archive too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available") as e:
        _entry(name, bed, host_archive, tmp_path)()
    assert "use_jax=False" in str(e.value) and "device='cpu'" in str(e.value)


def _tier_beds():
    from starch3_tpu_torch import corpus

    return {
        "bits4": corpus.make_bed(corpus.GENOME_CHROMS[:2], 700, seed=31),
        "bits5": corpus.config3_bed(seed=32, n_per=250),
        "bits6": corpus.bits6_bed(seed=33, n_per=250),
        "bits8": corpus.wide8_bed(seed=34, chroms=("chr1",), n_per=250),
    }


@pytest.mark.parametrize("how", ["use_jax_false", "platform_host", "platform_cpu"])
@pytest.mark.parametrize("tier", ["bits4", "bits5", "bits6", "bits8"])
def test_asks_for_the_cpu_equal_jax_host_path(tier, how, tmp_path):
    """Each explicit ask for the CPU, the native host codec
    (``use_jax=False``, ``--platform=host``) and the device path's plain
    versions (``--platform=cpu``, no ``--jax``), writes the JAX package's
    host-path archive on each alphabet tier; the API's host ask decodes it
    on the host."""
    bed = _tier_beds()[tier]
    want = jax_api.compress_bed_bytes(bed, JaxEncodeConfig())
    if how == "use_jax_false":
        got = api.compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        out = io.BytesIO()
        api.compress_bed_stream(io.BytesIO(bed), out, EncodeConfig(use_jax=False), chunk_bytes=4096)
        assert out.getvalue() == got
        assert api.decompress_starch_bytes(got, use_jax=False) == bed
    else:  # the CLI's main, in this process
        from starch3_tpu_torch import cli

        src, out = tmp_path / "in.bed", tmp_path / "out.starch"
        src.write_bytes(bed)
        assert cli.main([f"--platform={how.split('_')[1]}", f"--output={out}", str(src)]) == 0
        got = out.read_bytes()
    assert got == want


def test_gzip_default_needs_no_card(bed, tmp_path):
    """gzip has no device path: the default config's gzip encode, the
    flagless CLI's ``--gzip`` and the default decode of its archive run on
    the host, card or none, and write the JAX package's bytes."""
    from starch3_tpu_torch.config import CompressionMethod
    from starch3_tpu.config import CompressionMethod as JaxCompressionMethod

    want = jax_api.compress_bed_bytes(bed, JaxEncodeConfig(method=JaxCompressionMethod.GZIP))
    got = api.compress_bed_bytes(bed, EncodeConfig(method=CompressionMethod.GZIP))
    assert got == want
    assert api.decompress_starch_bytes(got) == bed
    from starch3_tpu_torch import cli

    src, out = tmp_path / "in.bed", tmp_path / "out.starch"
    src.write_bytes(bed)
    assert cli.main(["--gzip", f"--output={out}", str(src)]) == 0
    assert out.read_bytes() == want


def test_cli_decode_stays_on_the_host(bed, host_archive, tmp_path, capsys):
    """``--decode`` of a named file, ``--chrom`` and ``--list`` run on the
    host, with no card and no flag (the CLI's main, in this process; a
    decode from stdin: ``test_cli_cpu_platform_same_bytes``)."""
    from starch3_tpu_torch import cli

    arc, out = tmp_path / "a.starch", tmp_path / "out.bed"
    arc.write_bytes(host_archive)
    assert cli.main(["--decode", f"--output={out}", str(arc)]) == 0
    assert out.read_bytes() == bed
    assert cli.main(["--decode", "--chrom=chr2", f"--output={out}", str(arc)]) == 0
    assert out.read_bytes() == jax_api.extract_chromosome(host_archive, "chr2")
    capsys.readouterr()
    assert cli.main(["--list", str(arc)]) == 0
    assert capsys.readouterr().out.count("\n") == 4


@pytest.mark.parametrize(
    "args,msg",
    [
        # multi-host with neither a coordinator nor a manifest directory:
        # the reference's own refusal, on the reference's default (host) path
        (["--num-hosts=2", "--host-id=0", "--platform=host"], b"needs manifest_dir"),
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
        "assert a == api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))\n"
        "out = io.BytesIO()\n"
        "api.compress_bed_stream(io.BytesIO(bed), out, api.EncodeConfig(use_jax=True), device='cpu')\n"
        "assert out.getvalue() == a\n"
        "assert api.decompress_starch_bytes(a, use_jax=False) == bed\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()
