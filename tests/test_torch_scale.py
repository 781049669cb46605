"""The main path at scale, on the CPU at a small size: the scale corpus
(``corpus.gigabyte_bed``) against ``TestGigabyteScale.GEN`` of
``tests/test_archive.py``, the legs of ``starch3_tpu_torch.scale_run``
(the child processes of ``chip_smoke.py`` phases 13 to 15) on
``device="cpu"``, in every encode mode, and the device decode leg, and
the streaming file entry against the JAX package's with chromosomes
that span chunks and blocks.  Every child process is waited for."""

import ast
import hashlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from starch3_tpu import api as jax_api
from starch3_tpu.config import EncodeConfig as JaxEncodeConfig
from starch3_tpu_torch import api, corpus, scale_run
from starch3_tpu_torch.config import EncodeConfig

ROOT = Path(__file__).resolve().parent.parent


def _gen_script() -> str:
    """``TestGigabyteScale.GEN``, read from its source, not imported."""
    tree = ast.parse((ROOT / "tests" / "test_archive.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "TestGigabyteScale")
    return next(ast.literal_eval(s.value) for s in cls.body
                if isinstance(s, ast.Assign) and s.targets[0].id == "GEN")


def _run(args, **kw):
    return subprocess.run([sys.executable, *map(str, args)], capture_output=True, cwd=ROOT, timeout=120, **kw)


def _sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.mark.parametrize("n_per, target", [(2_000_000, 3_000_000), (3000, 200_000)],
                         ids=["gen_itself", "gen_3000_per_chromosome"])
def test_gigabyte_bed_writes_the_bytes_of_gen(tmp_path, n_per, target):
    """GEN run as a script, at seed 11; at 3,000 intervals a chromosome
    (GEN's ``n_per`` rewritten) the target spans several chromosomes."""
    script = _gen_script()
    assert "n_per = 2_000_000" in script
    (tmp_path / "gen.py").write_text(script.replace("n_per = 2_000_000", f"n_per = {n_per}"))
    r = _run([tmp_path / "gen.py", tmp_path / "gen.bed", target])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    want_digest, want_n = r.stdout.split()
    digest, n = corpus.gigabyte_bed(tmp_path / "mine.bed", target, n_per=n_per)
    assert (digest, n) == (want_digest.decode(), int(want_n))
    assert _sha256(tmp_path / "mine.bed") == digest
    assert (tmp_path / "mine.bed").read_bytes() == (tmp_path / "gen.bed").read_bytes()


def test_smaller_target_is_a_prefix(tmp_path):
    small = corpus.gigabyte_bed(tmp_path / "s.bed", 100_000, n_per=2000)
    big = corpus.gigabyte_bed(tmp_path / "b.bed", 300_000, n_per=2000)
    assert big[1] > small[1]
    assert (tmp_path / "b.bed").read_bytes()[: small[1]] == (tmp_path / "s.bed").read_bytes()


def test_decimal_columns_print_like_python():
    v = np.array([0, 7, 10, 99_999, 100_000, 123_456_789, 9_999_999_999], dtype=np.int64)
    digits, keep = corpus._decimal_columns(v)
    assert [digits[i][keep[i]].tobytes() for i in range(v.size)] == [b"%d" % x for x in v.tolist()]
    with pytest.raises(ValueError):
        corpus._decimal_columns(np.array([10**10]))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Three chromosomes of 15,000 intervals (about 320 kB of BED and
    135 kB of text each: two blocks at level 1), and the host path's
    archive of it at level 1."""
    d = tmp_path_factory.mktemp("scale")
    r = _run(["-m", "starch3_tpu_torch.scale_run", "gen", d / "in.bed", 700_000, "--n-per", 15_000])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    gen = json.loads(r.stdout.decode().splitlines()[-1])
    out = io.BytesIO()
    api.compress_bed_file(str(d / "in.bed"), out, EncodeConfig(use_jax=False, block_size_100k=1))
    (d / "host.starch").write_bytes(out.getvalue())
    return d, gen, hashlib.sha256(out.getvalue()).hexdigest()


def test_encode_leg_hybrid_round_trip(small):
    """Phase 13 (b) and (e) on the CPU: the hybrid through the file entry
    with 4 kB chunks, so every chromosome spans chunks.  How the 6 blocks
    split between the device and the stealers depends on the feed's pace
    (a missing class key counts 0 blocks); the next test makes the
    device's share certain."""
    d, gen, host_digest = small
    assert gen["bytes"] > 3 * 4096
    r = _run(["-m", "starch3_tpu_torch.scale_run", "encode", d / "in.bed", d / "b.starch", "--jax",
              "--device", "cpu", "--level", 1, "--chunk-bytes", 4096, "--decode"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["archive_digest"] == host_digest
    assert res["decode"]["digest"] == gen["digest"] == _sha256(d / "in.bed")
    assert res["decode"]["bytes"] == gen["bytes"]
    assert res["scheduler_stats"]["abandoned_batches"] == 0
    assert res["blocks"] == 6 and 0 < res["transform_seconds"] < res["seconds"]
    assert res["device_stats"].get("blocks_bits4", 0) <= res["blocks"]
    assert res["peak_rss_mb"] > 0


def test_encode_leg_hybrid_puts_a_batch_on_the_device(small, tmp_path, monkeypatch):
    """The same leg in this process, with the feed held open until the
    device has claimed a batch: while blocks may still arrive and the
    device's pipeline is not primed, the stealers leave a batch in each
    bucket to the device, so it takes one for certain (without the hold,
    fast stealers may take every block once the feed ends).  The archive
    is the host path's, and every thread the encode started has ended,
    apart from the process's tail pool."""
    import threading
    import time
    from types import SimpleNamespace

    from starch3_tpu_torch.parallel import host, pipeline

    class Queue(host._BlockQueue):
        def finish_feeding(self):
            deadline = time.monotonic() + 60
            with self.cond:
                while not (self.device_claimed or self.cancelled) and time.monotonic() < deadline:
                    self.cond.wait(0.01)
            super().finish_feeding()

    monkeypatch.setattr(pipeline, "_BlockQueue", Queue)
    monkeypatch.setattr(host, "_class_rate_cache", {})  # no class gated by an earlier encode's rate
    d, _gen, host_digest = small
    before = set(threading.enumerate())
    args = SimpleNamespace(inp=str(d / "in.bed"), out=str(tmp_path / "b.starch"), jax=True, device="cpu",
                           level=1, chunk_bytes=4096, decode=False, mode="fast", warm_up=False, cli=False)
    peak = scale_run.PeakRss().start()
    try:
        res = scale_run.leg_encode(args, peak)
    finally:
        peak.stop()
    assert res["archive_digest"] == host_digest
    assert res["scheduler_stats"]["abandoned_batches"] == 0
    assert res["device_stats"].get("blocks_bits4", 0) >= EncodeConfig().blocks_per_batch
    left = [t.name for t in threading.enumerate() if t not in before and not t.name.startswith("s3tail")]
    assert left == []


def test_device_leg_matches_every_stream(small):
    """Phase 13 (d) on the CPU: device only, every stream equal to the
    host archive's, in the traced run and in the timed one."""
    d, _gen, _ = small
    r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", "--device", "cpu",
              "--level", 1, "--chunk-bytes", 5000, d / "trace", d / "mismatch"],
             env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["faults"] == [] and res["mismatches"] == []
    assert res["streams"] == res["ref_streams"] == 3
    assert res["device_stats"]["blocks"] == res["blocks"] == 6
    assert res["traced"]["faults"] == [] and res["traced"]["blocks"] == 6
    assert res["traced"]["trace"]["batches"] == 0  # no kernel on the CPU
    assert not (d / "mismatch").exists()


def test_pipe_leg_equals_host_path(small, tmp_path):
    """Phase 13 (c) on the CPU: ``cat | cli --jax --platform=cpu``."""
    d, _gen, _ = small
    want = io.BytesIO()
    api.compress_bed_file(str(d / "in.bed"), want, EncodeConfig(use_jax=False))
    r = _run(["-m", "starch3_tpu_torch.scale_run", "pipe", d / "in.bed", tmp_path / "c.starch", "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["archive_digest"] == hashlib.sha256(want.getvalue()).hexdigest()
    assert (tmp_path / "c.starch").read_bytes() == want.getvalue()


def test_iter_chromosome_raw_splits_at_name_changes():
    bed = b"a\t1\t2\na\t3\t4\nbb\t1\t2\nc\t5\t6\nc\t7\t8\nc\t9\t10"
    for chunk in (1, 5, 7, 100):
        got = list(scale_run.iter_chromosome_raw(io.BytesIO(bed), chunk))
        assert got == [("a", b"a\t1\t2\na\t3\t4\n"), ("bb", b"bb\t1\t2\n"), ("c", b"c\t5\t6\nc\t7\t8\nc\t9\t10")]


def test_first_differing_block(small):
    d, _gen, _ = small
    from starch3_tpu_torch.format.archive import StarchReader

    meta, stream = next(StarchReader.from_bytes((d / "host.starch").read_bytes()).iter_streams())
    offs = meta.block_bit_offsets
    assert len(offs) == 2
    assert scale_run.first_differing_block(stream, offs, stream, offs) == 2
    flipped = bytearray(stream)
    flipped[offs[1] // 8 + 20] ^= 1
    assert scale_run.first_differing_block(bytes(flipped), offs, stream, offs) == 1
    flipped[offs[0] // 8 + 20] ^= 1
    assert scale_run.first_differing_block(bytes(flipped), offs, stream, offs) == 0


def test_file_entry_equals_jax_package_across_chunks_and_blocks(tmp_path):
    """One chromosome of 40,000 intervals: about 890 kB of BED in 55
    chunks of 16 kB and 4 blocks at level 1 (every one in the 131,072
    bucket, so JAX compiles one batch shape), its last line without a
    newline; the port on the CPU against the JAX package's device path."""
    corpus.gigabyte_bed(tmp_path / "g.bed", 1, n_per=40_000)
    bed = (tmp_path / "g.bed").read_bytes()[:-1]
    src = tmp_path / "in.bed"
    src.write_bytes(bed)
    assert not bed.endswith(b"\n") and len(bed) > 3 << 14
    cfg = dict(use_jax=True, block_size_100k=1)
    want = io.BytesIO()
    jax_api.compress_bed_file(str(src), want, JaxEncodeConfig(**cfg), chunk_bytes=1 << 14)
    got = io.BytesIO()
    api.compress_bed_file(str(src), got, EncodeConfig(**cfg), chunk_bytes=1 << 14, device="cpu")
    assert got.getvalue() == want.getvalue()
    from starch3_tpu_torch.format.archive import StarchReader

    meta = StarchReader.from_bytes(got.getvalue()).metadata
    assert len(meta.streams) == 1 and len(meta.streams[0].block_bit_offsets) >= 3
    assert not meta.final_newline
    assert api.decompress_starch_bytes(got.getvalue(), use_jax=False) == bed


@pytest.fixture
def forker():
    """A fork server of the scale legs (``leg_fork.LegForker``), closed
    when the test ends."""
    from starch3_tpu_torch import leg_fork

    with leg_fork.LegForker() as f:
        yield f


def test_scale_child_returns_a_leg_and_kills_one_past_its_limit(tmp_path, forker):
    """``chip_smoke.scale_child``, forked by the fork server: a leg's JSON
    line comes back with its start, CUDA and work seconds; a leg still
    running at its limit fails the phase and its process group is gone by
    then."""
    import time

    import chip_smoke

    res = chip_smoke.scale_child("gen", ["gen", tmp_path / "a.bed", 1000, "--n-per", 500], time.monotonic() + 60, 60,
                                 forker)
    assert res["digest"] == _sha256(tmp_path / "a.bed")
    assert set(res["times"]) == {"start_s", "cuda_init_s", "work_s"} and res["times"]["cuda_init_s"] == 0
    assert 0 < res["times"]["start_s"] < 60 and 0 < res["times"]["work_s"] < 60
    fifo = tmp_path / "never.bed"  # a pipe nobody writes: the leg blocks on it
    os.mkfifo(fifo)
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="still running"):
        chip_smoke.scale_child("blocked encode", ["encode", fifo, tmp_path / "b.starch"], time.monotonic() + 60, 2,
                               forker)
    assert time.monotonic() - t0 < 30
    r = subprocess.run(["pgrep", "-f", str(fifo)], capture_output=True)
    assert r.stdout == b""


def test_forked_leg_past_its_limit_is_killed_with_its_children(tmp_path, forker):
    """A forked ``pipe`` leg (``cat IN | cli --jax``, real processes of
    its group) blocked on a pipe nobody writes: at its limit the leg, the
    ``cat`` and the CLI are killed, and the server forks the next leg."""
    import time

    from starch3_tpu_torch import leg_fork

    fifo = tmp_path / "never-piped.bed"
    os.mkfifo(fifo)
    with pytest.raises(leg_fork.LegTimeout, match="still running after 3 s"):
        forker.run(["pipe", fifo, tmp_path / "p.starch", "--device", "cpu"], 3)
    deadline = time.monotonic() + 10  # the kill is sent; the kernel ends them
    while subprocess.run(["pgrep", "-f", str(fifo)], capture_output=True).stdout and time.monotonic() < deadline:
        time.sleep(0.1)
    assert subprocess.run(["pgrep", "-f", str(fifo)], capture_output=True).stdout == b""
    run = forker.run(["gen", tmp_path / "c.bed", 1000, "--n-per", 500], 60)
    assert run.returncode == 0 and json.loads(run.stdout.decode().splitlines()[-1])["bytes"] > 1000
    assert forker.wait_ready()["import_s"] > 0


def test_forked_legs_asked_together_before_the_server_is_ready(tmp_path, monkeypatch):
    """Two threads ask a new fork server for a leg at once, before its
    imports are done (``scale_run config4`` writes its corpus and prefix
    so): both legs run.  Before, the server's one "ready" line went to one
    waiter and the other waited for it until ``READY_S``."""
    import concurrent.futures

    from starch3_tpu_torch import leg_fork

    monkeypatch.setattr(leg_fork, "READY_S", 60.0)
    with leg_fork.LegForker() as fresh, concurrent.futures.ThreadPoolExecutor(2) as ex:
        runs = list(ex.map(lambda i: fresh.run(["gen", tmp_path / f"c{i}.bed", 1000, "--n-per", 500], 120), (0, 1)))
    assert [r.returncode for r in runs] == [0, 0]
    assert (tmp_path / "c0.bed").read_bytes() == (tmp_path / "c1.bed").read_bytes()


def test_forked_leg_keeps_its_exit_and_error(tmp_path, forker):
    """A forked leg has its own exit code and standard error: ``encode
    --mode`` without ``--jax`` is refused by argparse (exit 2); a leg whose
    input is missing fails with its traceback (exit 1)."""
    run = forker.run(["encode", tmp_path / "x.bed", tmp_path / "x.starch", "--mode", "ranks"], 60)
    assert run.returncode == 2 and b"give --jax" in run.stderr and run.stdout == b""
    run = forker.run(["encode", tmp_path / "missing.bed", tmp_path / "x.starch"], 60)
    assert run.returncode == 1 and b"FileNotFoundError" in run.stderr


def test_fork_server_refuses_to_fork_once_cuda_is_initialised(monkeypatch):
    """The server checks before each fork that it has not initialised
    CUDA, whose context a forked child could not use: with
    ``torch.cuda.is_initialized`` patched to True it raises and never
    forks."""
    import torch

    from starch3_tpu_torch import leg_fork

    def no_fork():
        raise AssertionError("forked")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(os, "fork", no_fork)
    with pytest.raises(RuntimeError, match="CUDA is initialised in the fork server"):
        leg_fork.fork_leg({"id": 0, "args": ["gen"], "stdout": "o", "stderr": "e"}, 1, 1 << 20)


@pytest.mark.parametrize("extra", ["python thread", "native thread"])
def test_fork_server_refuses_to_fork_beside_a_thread(monkeypatch, extra):
    """The server forks only on its one thread and the threads its imports
    left: with a Python thread running, or with one thread more than
    ``max_threads`` in the process, it raises and never forks."""
    import threading

    from starch3_tpu_torch import leg_fork

    def no_fork():
        raise AssertionError("forked")

    monkeypatch.setattr(os, "fork", no_fork)
    req = {"id": 0, "args": ["gen"], "stdout": "o", "stderr": "e"}
    if extra == "native thread":
        monkeypatch.setattr(threading, "active_count", lambda: 1)
        with pytest.raises(RuntimeError, match="its imports left"):
            leg_fork.fork_leg(req, 1, leg_fork.thread_count() - 1)
        return
    stop = threading.Event()
    t = threading.Thread(target=stop.wait)
    t.start()
    try:
        with pytest.raises(RuntimeError, match=r"\([2-9]\d* of Python\)"):
            leg_fork.fork_leg(req, 1, 1 << 20)
    finally:
        stop.set()
        t.join()


def test_fork_server_reports_its_threads_and_forks_on_them(tmp_path, forker):
    """The server's first reply counts the threads its imports left, and
    it forks legs beside them (NumPy's OpenBLAS pool stops itself before a
    fork): two legs in a row both run."""
    assert forker.wait_ready()["threads"] >= 1
    for name in ("a", "b"):
        run = forker.run(["gen", tmp_path / f"{name}.bed", 1000, "--n-per", 500], 60)
        assert run.returncode == 0, run.stderr.decode()[-2000:]


def test_fork_server_imports_what_the_profilers_first_start_imports():
    """In a process that imported the fork server's modules, the first
    ``torch.profiler`` start (each traced device-only leg's) imports no
    more of ``torch._inductor``, ``torch._dynamo`` or
    ``torch.distributed``: the server imported them once.  The imports
    past ``LEG_MODULES`` start no thread (the count after them, the
    server's ``threads``, is where its forks' guard stands) and leave CUDA
    uninitialised, as the server's forks require."""
    code = (
        "import importlib, os, sys, torch\n"
        "from starch3_tpu_torch import leg_fork\n"
        "for m in leg_fork.LEG_MODULES: importlib.import_module(m)\n"
        "legs = leg_fork.thread_count()\n"
        "for m in leg_fork.FORK_ONLY_MODULES: importlib.import_module(m)\n"
        "n, before = leg_fork.thread_count(), set(sys.modules)\n"
        "p = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]); p.__enter__()\n"
        "p.__exit__(None, None, None)\n"
        "print([m for m in set(sys.modules) - before if m.startswith(('torch._inductor', 'torch._dynamo', "
        "'torch.distributed'))], torch.cuda.is_initialized(), n - legs)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout.decode().split("\n")[-2] == "[] False 0"


def test_leg_times_split_the_start():
    from starch3_tpu_torch import leg_fork

    res = {"timing": {"main_at": 105.0, "imports_s": 2.5, "cuda_init_s": 1.25, "work_s": 30.0}}
    assert leg_fork.leg_times(res, 100.0) == {"start_s": 7.5, "cuda_init_s": 1.25, "work_s": 30.0}


def test_peak_rss_sees_a_transient_allocation():
    """``PeakRss`` holds the largest resident set its thread saw, after
    the memory is freed."""
    import time

    peak = scale_run.PeakRss(every_s=0.005).start()
    try:
        before = scale_run.rss_mb()
        block = np.ones(200 << 17)  # 200 MB, touched
        time.sleep(0.1)
        del block
    finally:
        peak.stop()
    assert peak.peak_mb() > before + 150
    assert not peak._thread.is_alive()


def test_peak_rss_reset_forgets_the_peak_so_far():
    """After ``reset`` the peak is the resident set from there on."""
    import time

    peak = scale_run.PeakRss(every_s=0.005).start()
    try:
        block = np.ones(200 << 17)  # 200 MB, touched
        time.sleep(0.05)
        high = peak.peak_mb()
        del block
        peak.reset()
        time.sleep(0.05)
        assert peak.peak_mb() < high - 150
    finally:
        peak.stop()


def test_peak_rss_keeps_a_series_with_the_c_heap_and_progress():
    """Each point of ``PeakRss.series`` is ``[seconds, RSS, C heap in
    use, C heap held, progress()]``; a live 100 MB allocation shows in
    the heap in use (glibc's ``mallinfo2``)."""
    import time

    done = [0]
    peak = scale_run.PeakRss(every_s=0.005, series_s=0.02, progress=lambda: done[0]).start()
    try:
        time.sleep(0.06)
        block = bytearray(100 << 20)
        done[0] = len(block)
        time.sleep(0.06)
        del block
    finally:
        peak.stop()
    assert len(peak.series) >= 4 and all(len(p) == 5 for p in peak.series)
    assert [p[0] for p in peak.series] == sorted(p[0] for p in peak.series)
    assert peak.series[0][4] == 0 and peak.series[-1][4] == 100 << 20
    heap = scale_run.c_heap_mb()
    assert heap is not None and heap[0] <= heap[1]
    in_use = [p[2] for p in peak.series]
    assert max(in_use) - in_use[0] > 90


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_gpu_busy_share_over_the_steady_window(tmp_path):
    """Twelve width-16 launches 1 ms apart, each 100 µs, and a 300 µs
    copy overlapping one of them: with ``skip=1`` the window runs from
    the second launch to the eleventh (9 batches, 9 ms), busy 1.2 ms of
    it (the launch at its end adds nothing); a CPU event is not counted."""
    events = [{"cat": "kernel", "name": "mtf16_kernel", "ts": 1000.0 * i, "dur": 100.0} for i in range(12)]
    events += [{"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2050.0, "dur": 300.0},
               {"cat": "cpu_op", "name": "aten::sort", "ts": 1000.0, "dur": 5000.0}]
    got = scale_run.gpu_busy_share(_trace(tmp_path, events), skip=1)
    assert got["batches"] == 9 and got["window_ms"] == pytest.approx(9.0)
    # launches 1..9 (100 µs each, the copy adds 250 µs past launch 2's end)
    assert got["busy_ms"] == pytest.approx(0.9 + 0.25)
    assert got["busy_share"] == pytest.approx(1.15 / 9.0)
    assert got["batches_per_s"] == pytest.approx(1000.0)
    assert got["device_ms_per_batch"] == pytest.approx(1.15 / 9)
    assert scale_run.gpu_busy_share(_trace(tmp_path, events[:3]), skip=1)["busy_share"] is None


# the BED6 scale shapes: (seed, ``n_per`` in the tests)
BED6 = {"config3": 7, "bits6": 13, "wide8": 17}
# and BASELINE config 4's and the aligned reads', whose size is the
# intervals of all their chromosomes
SHAPES = dict(BED6, config4=19, reads=23)


def _size(shape: str, n: int) -> dict:
    """A scale writer's size argument for ``n`` intervals in the first
    chromosome: ``n_per``, or for config4 and reads the ``n_total`` that
    gives chr1 ``n`` intervals."""
    if shape not in ("config4", "reads"):
        return {"n_per": n}
    return {"n_total": round(n * corpus.GRCH38_TOTAL / corpus.GRCH38_LENGTHS["chr1"])}


def _config4_lines(target: int, seed: int, n_total: int, run: int = 250_000) -> bytes:
    """Config 4's spec, line by line: GRCh38's chromosomes in order, each
    of its share of ``n_total`` intervals, in runs of ``run`` lines; for
    each run the site gaps (1..60 after 10,000), then which lines are
    indels (1 in 10), their lengths (2..50) and shifts (1..100); an SNV is
    ``site, site + 1``, an indel ``site - shift, site - shift + length``."""
    gen = np.random.default_rng(seed)
    out, n = [], 0
    for name, length in corpus.GRCH38_LENGTHS.items():
        if n >= target:
            break
        lines, last = round(n_total * length / corpus.GRCH38_TOTAL), 10_000
        for lo in range(0, lines, run):
            m = min(run, lines - lo)
            gaps, kind = gen.integers(1, 61, m).tolist(), gen.integers(0, 10, m).tolist()
            lens, shifts = gen.integers(2, 51, m).tolist(), gen.integers(1, 101, m).tolist()
            rows = []
            for i in range(m):
                last += gaps[i]
                start, stop = (last - shifts[i], last - shifts[i] + lens[i]) if kind[i] == 0 else (last, last + 1)
                rows.append(b"%s\t%d\t%d\n" % (name.encode(), start, stop))
            out.append(b"".join(rows))
            n += len(out[-1])
    return b"".join(out)


def _reads_lines(target: int, seed: int, n_total: int, run: int = 250_000) -> bytes:
    """The aligned reads' spec, line by line: GRCh38's chromosomes in
    order, each of its share of ``n_total`` reads, in runs of ``run``
    lines; for each run the geometric start gaps, which are 0 (1 in 20,
    never a run's first), which reads hold an indel (1 in 50), its size
    and whether it is a deletion, the flowcell, lane, tile, x and y of the
    name, whether the MAPQ is 42 and the rest's, the strand; the lines
    sorted by start, then end, the names in draw order."""
    gen = np.random.default_rng(seed)
    tiles = [base + t for base in (1101, 1201, 2101, 2201) for t in range(78)]
    runs = (b"45:HHKJ3DSXY", b"47:HGV2FDSXY")
    out, n = [], 0
    for name, length in corpus.GRCH38_LENGTHS.items():
        if n >= target:
            break
        lines, last = round(n_total * length / corpus.GRCH38_TOTAL), 10_000
        for lo in range(0, lines, run):
            m = min(run, lines - lo)
            gaps, dup = gen.geometric(lines / length, m).tolist(), (gen.integers(0, 20, m) == 0).tolist()
            indel, size, deletion = (gen.integers(0, 50, m) == 0).tolist(), gen.integers(1, 4, m).tolist(), \
                (gen.integers(0, 2, m) == 1).tolist()
            flowcell, lane, tile = gen.integers(0, 2, m).tolist(), gen.integers(1, 5, m).tolist(), \
                gen.integers(0, 312, m).tolist()
            x, y = gen.integers(1000, 32001, m).tolist(), gen.integers(1000, 37001, m).tolist()
            high, low, strand = (gen.integers(0, 5, m) != 0).tolist(), gen.integers(30, 42, m).tolist(), \
                gen.integers(0, 2, m).tolist()
            spans = []
            for i in range(m):
                last += 0 if dup[i] and i else gaps[i]
                spans.append((last, last + 50 + ((size[i] if deletion[i] else -size[i]) if indel[i] else 0)))
            rows = [b"%s\t%d\t%d\tA00123:%s:%d:%d:%d:%d\t%d\t%s\n" % (
                name.encode(), start, stop, runs[flowcell[i]], lane[i], tiles[tile[i]], x[i], y[i],
                42 if high[i] else low[i], b"+" if strand[i] else b"-") for i, (start, stop) in enumerate(sorted(spans))]
            out.append(b"".join(rows))
            n += len(out[-1])
    return b"".join(out)


def _check_reads(bed: bytes, run: int) -> None:
    """The aligned reads' columns, line by line: an Illumina name of the
    two flowcells, lanes 1..4, the S4 tiles, x and y in range; MAPQ 42 or
    30..41; spans of 47..53 (50 but for the indels); lines in order of
    start, then end, within a chromosome, across the runs of ``run``
    lines, some starts repeated but never at a run's first line."""
    name = re.compile(rb"A00123:(45:HHKJ3DSXY|47:HGV2FDSXY):([1-4]):([12][12][0-9]{2}):([0-9]+):([0-9]+)")
    tiles = {base + t for base in (1101, 1201, 2101, 2201) for t in range(78)}
    spans, mapqs, flowcells, per_chrom = set(), set(), set(), {}
    for line in bed.splitlines():
        chrom, start, stop, qname, mapq, strand = line.split(b"\t")
        f = name.fullmatch(qname)
        assert f and int(f[3]) in tiles and 1000 <= int(f[4]) <= 32000 and 1000 <= int(f[5]) <= 37000, line
        assert strand in (b"+", b"-") and (int(mapq) == 42 or 30 <= int(mapq) <= 41), line
        spans.add(int(stop) - int(start))
        mapqs.add(int(mapq))
        flowcells.add(f[1])
        per_chrom.setdefault(chrom, []).append((int(start), int(stop)))
    assert spans <= set(range(47, 54)) and 50 in spans and len(spans) > 2
    assert 42 in mapqs and len(mapqs) > 2 and len(flowcells) == 2
    for pairs in per_chrom.values():
        assert pairs == sorted(pairs)
        starts = [p[0] for p in pairs]
        assert len(set(starts)) < len(starts)  # duplicate starts
        assert all(starts[i] > starts[i - 1] for i in range(run, len(starts), run))


def _bed6_lines(shape: str, target: int, seed: int, n_per: int, run: int = 250_000) -> bytes:
    """The BED6 writers' draws (``corpus._bed6_scale``), formatted line by
    line with ``%``, as the smoke generators format them."""
    gen = np.random.default_rng(seed)
    out, n, c = [], 0, 0
    while n < target:
        c += 1
        last = 10_000
        for lo in range(0, n_per, run):
            m = min(run, n_per - lo)
            starts = (last + np.cumsum(gen.integers(1, 2000, m))).tolist()
            stops = (np.array(starts) + gen.integers(20, 500, m)).tolist()
            last = starts[-1]
            if shape == "config3":
                sc, st = gen.integers(0, 1000, m).tolist(), gen.integers(0, 2, m).tolist()
                rest = [b"peak_%d\t%d\t%s" % (lo + i, sc[i], b"+" if st[i] else b"-") for i in range(m)]
            elif shape == "bits6":
                pk = gen.integers(0, 16, (m, 3)).tolist()
                sc, st = gen.integers(0, 100_000, m).tolist(), gen.integers(0, 2, m).tolist()
                rest = []
                for i in range(m):
                    gene = b"".join(corpus._SYLLABLES[j] for j in pk[i]) + b"_%d.%d" % ((lo + i) % 97, sc[i] % 10)
                    rest.append(b"%s\t%d.%02d\t%s" % (gene, sc[i] // 100, sc[i] % 100, b"+" if st[i] else b"-"))
            else:
                lens = gen.integers(12, 21, m)
                chars = corpus._NAME_CHARS[gen.integers(0, 64, (m, 20))]
                sc, st = gen.integers(0, 1000, m).tolist(), gen.integers(0, 2, m).tolist()
                rest = [b"%s\t%d\t%s" % (chars[i, : lens[i]].tobytes(), sc[i], b"+" if st[i] else b"-")
                        for i in range(m)]
            chunk = b"".join(b"chr%d\t%d\t%d\t%s\n" % (c, starts[i], stops[i], rest[i]) for i in range(m))
            out.append(chunk)
            n += len(chunk)
    return b"".join(out)


@pytest.mark.parametrize("run", [250_000, 700], ids=["one_run", "runs_of_700"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bed6_writer_equals_a_line_loop(tmp_path, monkeypatch, shape, run):
    """Each scale writer's NumPy formatting against ``%`` line by line, on
    the same draws, across chromosomes: each chromosome one run of lines,
    or (``corpus._LINES`` set to 700) four, the last cut short, so that
    each run carries the start, the ``peak_`` ids and the ``% 97``
    suffixes from the run before it.  Config 4's starts go back in chr1;
    the BED6 shapes' never do, and only the reads repeat a start.  The
    reads' chromosomes are 150 kB at 2,500 reads (9-digit starts), so
    they are cut at 400 kB."""
    monkeypatch.setattr(corpus, "_LINES", run)
    target = 400_000 if shape == "reads" else 250_000
    digest, n = corpus.SCALE_SHAPES[shape](tmp_path / "w.bed", target, **_size(shape, 2500))
    got = (tmp_path / "w.bed").read_bytes()
    if shape == "config4":
        assert got == _config4_lines(target, SHAPES[shape], _size(shape, 2500)["n_total"], run=run)
    elif shape == "reads":
        assert got == _reads_lines(target, SHAPES[shape], _size(shape, 2500)["n_total"], run=run)
        _check_reads(got, run)
    else:
        assert got == _bed6_lines(shape, target, BED6[shape], 2500, run=run)
    assert (digest, n) == (hashlib.sha256(got).hexdigest(), len(got)) and n >= target
    assert got.count(b"\nchr3\t") >= 1
    if run == 700:
        first = got[: got.index(b"\nchr2\t") + 1].splitlines()
        starts = [int(line.split(b"\t")[1]) for line in first]
        assert len(first) == 2500 and (starts == sorted(starts)) == (shape not in corpus.SCALE_UNSORTED)
        assert (len(set(starts)) == 2500) == (shape not in ("config4", "reads"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bed6_smaller_target_is_a_prefix(tmp_path, shape):
    small = corpus.SCALE_SHAPES[shape](tmp_path / "s.bed", 60_000, **_size(shape, 900))
    big = corpus.SCALE_SHAPES[shape](tmp_path / "b.bed", 200_000, **_size(shape, 900))
    assert big[1] > small[1] >= 60_000
    assert (tmp_path / "b.bed").read_bytes()[: small[1]] == (tmp_path / "s.bed").read_bytes()


def _running_union(starts, stops) -> int:
    """The native transform's union length on its sorted path, a running
    maximum over the lines in their order: right only where no start goes
    back."""
    total, run = 0, None
    for s, e in zip(starts.tolist(), stops.tolist()):
        lo = s if run is None else max(s, run)
        total += max(e - lo, 0)
        run = e if run is None else max(run, e)
    return total


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bed6_every_block_is_of_its_tier(tmp_path, shape):
    """Every block of every chromosome, at level 1 and at level 9, is of
    the shape's tier, its last (short) block too.  In config 4's every
    chromosome some deltas are negative and some starts go back, and the
    native transform took its unsorted branch: its union length is the
    one over the lines sorted by start, not the running maximum of its
    sorted path."""
    from starch3_tpu_torch.bed.parser import parse_bed
    from starch3_tpu_torch.parallel.host import _split_classify
    from starch3_tpu_torch.transform.delta import _union_length

    # 3 blocks at level 1 in chr1, and more than one chromosome
    n, target = (90_000, 2_000_000) if shape == "config4" else (15_000, 1_500_000)
    corpus.SCALE_SHAPES[shape](tmp_path / "t.bed", target, **_size(shape, n))
    bed = (tmp_path / "t.bed").read_bytes()
    transformed = api._parse_transform(bed)
    assert len(transformed) >= 2
    for tf in transformed:
        for level in (1, 9):
            blocks, classes = _split_classify(tf.text, level)
            assert set(classes) == {corpus.SCALE_TIERS[shape]}, (tf.chrom, level, classes)
    assert len(_split_classify(transformed[0].text, 1)[0]) >= 3
    if shape == "config4":
        for tf, chrom in zip(transformed, parse_bed(bed)):
            assert re.search(rb"(^|\n)-[0-9]", bytes(tf.text)), tf.chrom
            assert scale_run.starts_back(bed[bed.index(tf.chrom.encode() + b"\t"):]) > 0
            assert tf.base_count_unique == _union_length(chrom.starts, chrom.stops)
            assert tf.base_count_unique != _running_union(chrom.starts, chrom.stops), tf.chrom


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bed6_file_entry_equals_jax_package(tmp_path, shape):
    """One chromosome of 6,000 intervals (2-3 blocks at level 1; config
    4's of 60,000, 2 blocks) in 16 kB chunks, so that it is carried across
    many: the port's file entry on the CPU against the JAX package's,
    byte for byte."""
    corpus.SCALE_SHAPES[shape](tmp_path / "in.bed", 1, **_size(shape, 60_000 if shape == "config4" else 6_000))
    src = str(tmp_path / "in.bed")
    assert os.path.getsize(src) > 8 << 14
    cfg = dict(use_jax=True, block_size_100k=1)
    want = io.BytesIO()
    jax_api.compress_bed_file(src, want, JaxEncodeConfig(**cfg), chunk_bytes=1 << 14)
    got = io.BytesIO()
    api.compress_bed_file(src, got, EncodeConfig(**cfg), chunk_bytes=1 << 14, device="cpu")
    assert got.getvalue() == want.getvalue()
    from starch3_tpu_torch.format.archive import StarchReader

    meta = StarchReader.from_bytes(got.getvalue()).metadata
    assert len(meta.streams) == 1 and len(meta.streams[0].block_bit_offsets) >= 2
    assert api.decompress_starch_bytes(got.getvalue(), use_jax=False) == (tmp_path / "in.bed").read_bytes()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bed6_gen_and_device_legs(tmp_path, shape):
    """``gen --shape`` and the ``device`` leg on the CPU: the corpus is the
    writer's, every stream equals the host archive's, every block is of
    the tier, the launch check by width passes (on the CPU the wrappers
    count nothing), and the leg counts the chromosomes whose starts go
    back: all of config 4's, none of the others'.  The reads' longer
    lines are cut at 350 kB, for more than one chromosome."""
    size = _size(shape, 2_500)
    (flag, n), = size.items()
    target = 350_000 if shape == "reads" else 150_000
    r = _run(["-m", "starch3_tpu_torch.scale_run", "gen", tmp_path / "in.bed", target, "--shape", shape,
              "--" + flag.replace("_", "-"), n])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    gen = json.loads(r.stdout.decode().splitlines()[-1])
    assert gen["shape"] == shape and gen["tier"] == corpus.SCALE_TIERS[shape]
    assert gen["digest"] == corpus.SCALE_SHAPES[shape](tmp_path / "w.bed", target, **size)[0]
    out = io.BytesIO()
    api.compress_bed_file(str(tmp_path / "in.bed"), out, EncodeConfig(use_jax=False, block_size_100k=1))
    (tmp_path / "host.starch").write_bytes(out.getvalue())
    r = _run(["-m", "starch3_tpu_torch.scale_run", "device", tmp_path / "in.bed", tmp_path / "host.starch",
              tmp_path / "trace", tmp_path / "mismatch", "--device", "cpu", "--level", 1, "--shape", shape],
             env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["faults"] == [] and res["traced"]["faults"] == []
    tier = str(corpus.SCALE_TIERS[shape])
    assert res["per_class"][tier]["blocks"] == res["blocks"] == res["device_stats"]["blocks"] >= 2
    assert res["per_class"][tier]["batches"] == res["device_stats"]["batches"]
    assert set(res["width_launches"]) == {"16", "32", "64", "128", "256"}
    assert not any(res["width_launches"].values())
    back = res["starts_back"]
    assert back["of"] == res["streams"] >= 2
    assert back["chroms"] == (back["of"] if shape == "config4" else 0) and (back["lines"] > 0) == (shape == "config4")


def test_device_leg_fails_a_block_off_its_tier(small, tmp_path):
    """The bits-4 corpus run as ``--shape config3``: its blocks are not of
    bits 5, and the leg fails."""
    d, _gen, _ = small
    r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", tmp_path / "trace",
              tmp_path / "mismatch", "--device", "cpu", "--level", 1, "--shape", "config3"],
             env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
    assert r.returncode == 1
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert any("bits-5 blocks 0 != all blocks 6" in f for f in res["faults"])


def test_launch_faults_hold_widths_to_batches_by_class():
    """One MTF launch per device batch, at its class's width, on a card;
    nothing counted on the CPU."""
    stats = {"batches": 9, "batches_bits4": 2, "batches_bits5": 3, "batches_bits6": 1, "batches_bits8": 3}
    launches = {"16": 2, "32": 3, "64": 1, "128": 0, "256": 3}
    assert scale_run.launch_faults({"device_stats": stats, "width_launches": launches}, "cuda") == []
    off = dict(launches, **{"32": 2, "64": 2})
    assert len(scale_run.launch_faults({"device_stats": stats, "width_launches": off}, "cuda")) == 1
    zero = dict.fromkeys(launches, 0)
    assert scale_run.launch_faults({"device_stats": stats, "width_launches": zero}, "cpu") == []
    assert len(scale_run.launch_faults({"device_stats": stats, "width_launches": launches}, "cpu")) == 1


def test_counters_split_by_class(monkeypatch):
    """``per_class`` reads each class's share of the device counters and
    of the driver's class skips; a graph's capture and replay count in
    its class."""
    from starch3_tpu_torch.parallel import pipeline

    scale_run._zero_counters()
    try:
        pipeline.device_stats.add(**{"blocks": 3, "blocks_bits8": 3, "graph_captures": 1, "graph_captures_bits8": 1,
                           "class_skips_bits5": 4})
        got = scale_run._counters()["per_class"]
    finally:
        scale_run._zero_counters()
    assert got["8"] == {"blocks": 3, "batches": 0, "tie_reencodes": 0, "huff_host_reencodes": 0, "d2h_bytes": 0,
                        "graph_captures": 1, "graph_replays": 0, "class_skips": 0}
    assert got["5"]["class_skips"] == 4 and got["4"] == dict.fromkeys(scale_run.PER_CLASS, 0)


def test_save_block_case_keeps_a_blocks_mtf_case(tmp_path):
    """The case a differing stream leaves: its block's BWT (the MTF input),
    the kernel's and the plain version's ranks (on the CPU the wrapper
    runs the plain version, so they agree), for the block's class."""
    import torch

    corpus.wide8_scale_bed(tmp_path / "w.bed", 1, n_per=5_000)
    text = api._parse_transform((tmp_path / "w.bed").read_bytes())[0].text
    got = scale_run.save_block_case(text, 1, 1, "cpu", str(tmp_path / "mismatch-x.pt"))
    case = torch.load(tmp_path / "mismatch-x.pt")
    assert got["bits"] == case["bits"] == 8 and got["width"] == case["width"] == 256
    assert got["kernel_equals_plain"] and torch.equal(case["got"], case["want"])
    assert case["seqs"].shape == (1, 131_072) and len(case["block"]) == got["n"] > 0
    assert int(case["seqs"][0, : got["n"]].max()) < 256
    assert scale_run.save_block_case(text, 5, 1, "cpu", str(tmp_path / "mismatch-y.pt")) == {
        "skipped": "block 5 of 2"}
    assert not (tmp_path / "mismatch-y.pt").exists()


def test_device_run_keeps_a_mismatch_record_before_its_case(small, tmp_path, monkeypatch):
    """A stream that differs from REF's: its text and record are written
    as it is found, the counters are read before its MTF case is made (the
    case's own launches do not count), and a case that raises stays in the
    record while the mismatch fails the run."""
    from types import SimpleNamespace

    from starch3_tpu_torch.format.archive import StarchReader
    from starch3_tpu_torch.ops import mtf_narrow

    d, _gen, _ = small
    want = list(StarchReader.from_bytes((d / "host.starch").read_bytes()).iter_streams())
    tfs = api._parse_transform((d / "in.bed").read_bytes())
    texts, chroms = [t.text for t in tfs], [t.chrom for t in tfs]
    meta, stream = want[1]
    want[1] = (meta, stream[:-1] + bytes([stream[-1] ^ 1]))
    record = tmp_path / f"scale-mismatch-{chroms[1]}.json"

    def case(text, k, level, device, path, mode):
        assert mode == "fast"
        assert json.loads(record.read_text()) == {"stream": 1, "chrom": chroms[1], "ref_chrom": chroms[1],
                                                  "first_block": 1}
        mtf_narrow.width_launches[16] += 1
        raise RuntimeError("the case failed")

    monkeypatch.setattr(scale_run, "save_block_case", case)
    monkeypatch.setenv("STARCH3_TPU_NO_HOST_FALLBACK", "1")
    args = SimpleNamespace(level=1, device="cpu", mismatch_dir=str(tmp_path), shape="bed3", mode="fast")
    try:
        run = scale_run._device_run(texts, chroms, want, args)
    finally:
        scale_run._zero_counters()
    assert run["faults"] == ["1 streams differ from REF's, 3 streams of 3"]
    assert run["width_launches"]["16"] == 0
    assert json.loads(record.read_text())["mtf"] == {"error": "RuntimeError('the case failed')"}
    assert (tmp_path / f"scale-mismatch-{chroms[1]}.text").read_bytes() == texts[1]


def _line_count_off(data: bytes) -> bytes:
    """The archive ``data`` with its streams as they are and its first
    stream's line count one more: its metadata no longer the corpus's."""
    from starch3_tpu_torch.format.archive import StarchReader, StarchWriter

    reader = StarchReader.from_bytes(data)
    writer = StarchWriter(note=reader.metadata.note, compression=reader.metadata.compression_format)
    for i, (sm, stream) in enumerate(reader.iter_streams()):
        writer.add_stream(sm.chromosome, stream, uncompressed_size=sm.uncompressed_size,
                          line_count=sm.line_count + (i == 0), base_count_nonunique=sm.base_count_nonunique,
                          base_count_unique=sm.base_count_unique, block_bit_offsets=sm.block_bit_offsets)
    return writer.finish()


@pytest.mark.parametrize("level, change, prefix", [(1, None, True), (9, None, False), (1, _line_count_off, False)],
                         ids=["half", "other_level", "metadata"])
def test_streams_are_a_prefix(small, tmp_path, level, change, prefix):
    """Phase 13 and 14's half check: the archive of a corpus's first
    chromosomes is the whole archive's first streams with their metadata,
    byte for byte; a corpus's archive at another level is not, nor one
    whose streams are the whole's first but whose metadata differ."""
    d, _gen, _ = small
    bed = (d / "in.bed").read_bytes()
    (tmp_path / "h.bed").write_bytes(bed[: bed.index(b"\nchr3\t") + 1])
    out = io.BytesIO()
    api.compress_bed_file(str(tmp_path / "h.bed"), out, EncodeConfig(use_jax=False, block_size_100k=level))
    (tmp_path / "half.starch").write_bytes(change(out.getvalue()) if change else out.getvalue())
    assert scale_run.is_prefix_archive(str(tmp_path / "half.starch"), str(d / "host.starch")) == prefix


# the encode modes past fast mode (phase 15)
OTHER_MODES = ("fast_huff", "ranks", "rle2")


def test_modes_are_the_pipelines():
    """``scale_run.MODES`` gives each mode the flags that
    ``pipeline.encode_mode`` reads as that mode."""
    from starch3_tpu_torch.parallel import pipeline

    assert {m: pipeline.encode_mode(**flags) for m, flags in scale_run.MODES.items()} == {
        m: m for m in scale_run.MODES}


@pytest.mark.parametrize("chunk_bytes", [1 << 14, 1 << 16], ids=["chunks_16k", "chunks_64k"])
@pytest.mark.parametrize("mode", OTHER_MODES)
def test_file_entry_in_each_mode_equals_jax_package(tmp_path, mode, chunk_bytes):
    """Two chromosomes of 15,000 intervals (about 320 kB of BED each, two
    blocks at level 1) through the file entry in ``mode``, in chunks that
    each chromosome spans: the port on the CPU against the JAX package's
    ``compress_bed_file`` with the same ``EncodeConfig``, byte for byte."""
    corpus.gigabyte_bed(tmp_path / "in.bed", 400_000, n_per=15_000)
    src = str(tmp_path / "in.bed")
    cfg = dict(use_jax=True, block_size_100k=1, **scale_run.MODES[mode])
    want = io.BytesIO()
    jax_api.compress_bed_file(src, want, JaxEncodeConfig(**cfg), chunk_bytes=chunk_bytes)
    got = io.BytesIO()
    api.compress_bed_file(src, got, EncodeConfig(**cfg), chunk_bytes=chunk_bytes, device="cpu")
    assert got.getvalue() == want.getvalue()
    from starch3_tpu_torch.format.archive import StarchReader

    meta = StarchReader.from_bytes(got.getvalue()).metadata
    assert len(meta.streams) == 2 and all(len(m.block_bit_offsets) == 2 for m in meta.streams)
    assert api.decompress_starch_bytes(got.getvalue(), use_jax=False) == (tmp_path / "in.bed").read_bytes()


@pytest.mark.parametrize("mode", OTHER_MODES)
def test_mode_legs_pass_their_checks(small, tmp_path, mode):
    """Phase 15's (b) and (d) on the CPU: ``encode --jax --mode M
    --warm-up`` writes the host archive, and ``device --mode M --untraced
    --host-rate`` (its one timed encode, then the host cores on the same
    texts) gives every stream of it; both name their mode, abandon
    nothing and pass the launch check (on the CPU nothing is counted), and
    the exact modes re-encode no tied block."""
    d, _gen, host_digest = small
    r = _run(["-m", "starch3_tpu_torch.scale_run", "encode", d / "in.bed", tmp_path / "b.starch", "--jax",
              "--mode", mode, "--warm-up", "--device", "cpu", "--level", 1, "--chunk-bytes", 4096])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    hybrid = json.loads(r.stdout.decode().splitlines()[-1])
    assert hybrid["mode"] == mode and hybrid["archive_digest"] == host_digest and hybrid["faults"] == []
    assert hybrid["scheduler_stats"]["abandoned_batches"] == 0
    # the warm-up encoded the first chromosome's text (two blocks), before the counters were set to 0
    assert hybrid["warm_up"]["text_bytes"] > 100_000 and hybrid["device_stats"].get("blocks", 0) <= 6
    r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", tmp_path / "trace",
              tmp_path / "mismatch", "--device", "cpu", "--level", 1, "--mode", mode, "--untraced", "--host-rate"],
             env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["mode"] == mode and res["faults"] == [] and res["mismatches"] == []
    assert res["host"]["streams_differ"] == 0 and res["host"]["mb_per_s_text"] > 0
    assert "traced" not in res and not (tmp_path / "trace").exists()
    assert res["device_stats"]["blocks"] == res["blocks"] == res["per_class"]["4"]["blocks"] == 6
    assert res["per_class"]["4"]["tie_reencodes"] == 0
    # the bytes read back a block: the exact modes' rows are their width
    d2h = res["d2h_bytes_per_block"]["4"]
    rows = {"ranks": 257 + 131_072 // 4, "rle2": 518 + (131_072 + 3) // 2}
    assert d2h == rows[mode] * 4 if mode in rows else 0 < d2h < 131_072
    assert not any(res["width_launches"].values())


def test_encode_leg_wants_jax_for_a_mode(small, tmp_path):
    d, _gen, _ = small
    r = _run(["-m", "starch3_tpu_torch.scale_run", "encode", d / "in.bed", tmp_path / "a.starch", "--mode", "ranks"])
    assert r.returncode == 2 and b"give --jax" in r.stderr


@pytest.mark.parametrize("device, mode, flags", [
    (None, "fast", ["--platform=host"]),
    ("cpu", "fast", ["--platform=cpu"]),
    ("cuda", "fast", []),
    ("cuda", "fast_huff", ["--device-huffman"]),
])
def test_cli_flags_ask_for_all_but_the_card(device, mode, flags):
    """A user's CLI command for an encode: no flag on the card, the CLI's
    default; the host path and the plain versions are asked for."""
    assert scale_run.cli_flags(device, mode) == flags


def test_encode_leg_through_the_cli(small, tmp_path):
    """``encode --cli``: the host path as ``--platform=host`` and the
    device path on the CPU as ``--platform=cpu``, each the CLI's ``main``
    at level 9 with the leg's counters; both archives equal the JAX
    package's host path, and a level the CLI has no flag for is refused."""
    d, _gen, _ = small
    want = hashlib.sha256(jax_api.compress_bed_bytes((d / "in.bed").read_bytes(), JaxEncodeConfig())).hexdigest()
    for name, flags, argv in (("host", [], ["--platform=host"]), ("cpu", ["--jax", "--device", "cpu"],
                                                                   ["--platform=cpu"])):
        out = tmp_path / f"{name}.starch"
        r = _run(["-m", "starch3_tpu_torch.scale_run", "encode", d / "in.bed", out, "--cli", *flags])
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        res = json.loads(r.stdout.decode().splitlines()[-1])
        assert res["cli"] == [*argv, f"--output={out}", str(d / "in.bed")]
        assert res["archive_digest"] == want and res["faults"] == []
        assert 0 < res["transform_seconds"] < res["seconds"]
        if name == "host":  # (the hybrid's share of the device is not certain: its stealers may take all)
            assert res["device_stats"].get("batches", 0) == 0
    r = _run(["-m", "starch3_tpu_torch.scale_run", "encode", d / "in.bed", tmp_path / "x.starch", "--cli",
              "--level", 1])
    assert r.returncode == 2 and b"--cli encodes as the CLI does" in r.stderr


# a device-only run's batches by class: 2 of bits 4, 3 of bits 5, 1 of bits 6, 3 of bits 8
MODE_STATS = {"batches": 9, "batches_bits4": 2, "batches_bits5": 3, "batches_bits6": 1, "batches_bits8": 3}


@pytest.mark.parametrize("mode, launches", [
    ("fast", {"16": 2, "32": 3, "64": 1, "128": 0, "256": 3}),
    ("fast_huff", {"16": 0, "32": 0, "64": 0, "128": 2, "256": 7}),
    ("ranks", {"16": 0, "32": 0, "64": 0, "128": 0, "256": 9}),
    ("rle2", {"16": 0, "32": 0, "64": 0, "128": 0, "256": 9}),
])
def test_launch_faults_per_mode(mode, launches):
    """Each mode's widths: the right launches pass, one batch counted at
    another width fails, and on the CPU nothing may be counted."""
    ok = {"device_stats": MODE_STATS, "width_launches": launches}
    assert scale_run.launch_faults(ok, "cuda", mode) == []
    for src, dst in (("256", "128"), ("16", "256"), ("128", "256")):
        if launches[src]:
            moved = dict(launches, **{src: launches[src] - 1, dst: launches[dst] + 1})
            faults = scale_run.launch_faults({"device_stats": MODE_STATS, "width_launches": moved}, "cuda", mode)
            assert len(faults) == 1 and faults[0].startswith(f"{mode}: MTF launches by width")
    zero = {"device_stats": MODE_STATS, "width_launches": dict.fromkeys(launches, 0)}
    assert scale_run.launch_faults(zero, "cpu", mode) == []
    assert len(scale_run.launch_faults(ok, "cpu", mode)) == 1


@pytest.mark.parametrize("mode", sorted(scale_run.MODES))
def test_counter_faults_want_no_ties_in_the_exact_modes(mode):
    zero = dict.fromkeys(("16", "32", "64", "128", "256"), 0)
    tied = {"device_stats": dict(MODE_STATS, tie_reencodes=1), "width_launches": zero}
    faults = scale_run.counter_faults(tied, "cpu", mode)
    assert faults == ([f"{mode}: 1 tie re-encodes, where the exact BWT has none"] if mode in ("ranks", "rle2") else [])


@pytest.mark.parametrize("mode, shape, bits, width", [
    ("fast_huff", "bed3", 4, 128), ("fast_huff", "wide8", 8, 256), ("ranks", "bed3", 4, 256),
    ("rle2", "wide8", 8, 256)])
def test_save_block_case_uses_the_modes_input_and_width(tmp_path, mode, shape, bits, width):
    """A mode's case: the block through that mode's BWT, at its width; in
    the exact modes the plain ranks of the saved input are the ranks
    ``step_exact`` puts in the block's row."""
    import torch

    from starch3_tpu_torch.parallel import host, pipeline

    corpus.SCALE_SHAPES[shape](tmp_path / "c.bed", 1, n_per=5_000)
    text = api._parse_transform((tmp_path / "c.bed").read_bytes())[0].text
    got = scale_run.save_block_case(text, 0, 1, "cpu", str(tmp_path / "mismatch-m.pt"), mode)
    case = torch.load(tmp_path / "mismatch-m.pt")
    assert (got["bits"], got["width"], got["mode"]) == (bits, width, mode) == (case["bits"], case["width"],
                                                                                case["mode"])
    assert got["kernel_equals_plain"] and int(case["seqs"][0, : got["n"]].max()) < width
    if mode in ("ranks", "rle2"):
        block = host._split_classify(text, 1)[0][0].data
        raw, lens = pipeline.raw_batch([block], case["seqs"].shape[1])
        rows = pipeline.step_exact(raw, torch.from_numpy(lens))
        ranks = pipeline._unpack_results(rows.numpy(), lens, 1, case["seqs"].shape[1])[0][2]
        assert np.array_equal(case["want"][0, : got["n"]].numpy(), ranks)


def test_decode_leg_gives_back_the_corpus_as_the_jax_package(small, tmp_path):
    """Phase 15 (g) on the CPU: ``decode`` of the host archive gives back
    the corpus, decodes its 6 blocks on the device path and times the
    host's walk of its 3 streams and its RLE1 and CRC of the 6 blocks; the
    JAX package's ``decompress_starch_bytes(use_jax=True)`` gives the
    same bytes.  Cut to the archive of the first stream (``--streams 1``)
    it gives the first chromosome.  Against another corpus the leg
    fails."""
    d, gen, _ = small
    r = _run(["-m", "starch3_tpu_torch.scale_run", "decode", d / "host.starch", d / "in.bed", "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert (res["digest"], res["bytes"]) == (gen["digest"], gen["bytes"]) and res["faults"] == []
    assert res["archive_blocks"] == res["device_stats"]["decode_blocks"] == 6
    assert res["device_stats"]["decode_batches"] >= 1
    assert res["host_calls"] == {"read_stream_blocks": 3, "rle1_decode": 6, "crc32_bytes": 6}
    assert all(v > 0 for v in res["host_ms_per_block"].values()) and res["peak_rss_mb"] > 0
    want = jax_api.decompress_starch_bytes((d / "host.starch").read_bytes(), use_jax=True)
    assert hashlib.sha256(want).hexdigest() == res["digest"]
    # cut to the archive of the first stream: the corpus's first chromosome, its 2 blocks
    r = _run(["-m", "starch3_tpu_torch.scale_run", "decode", d / "host.starch", d / "in.bed", "--device", "cpu",
              "--streams", 1])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    cut = json.loads(r.stdout.decode().splitlines()[-1])
    bed = (d / "in.bed").read_bytes()
    first = bed[: bed.index(b"\nchr2\t") + 1]
    assert cut["corpus"] == {"digest": hashlib.sha256(first).hexdigest(), "bytes": len(first), "streams": 1}
    assert (cut["digest"], cut["bytes"], cut["streams"]) == (cut["corpus"]["digest"], len(first), 1)
    assert cut["archive_blocks"] == cut["device_stats"]["decode_blocks"] == 2 and cut["faults"] == []
    (tmp_path / "other.bed").write_bytes((d / "in.bed").read_bytes()[:-1] + b"\t")
    r = _run(["-m", "starch3_tpu_torch.scale_run", "decode", d / "host.starch", tmp_path / "other.bed",
              "--device", "cpu"])
    assert r.returncode == 1
    assert json.loads(r.stdout.decode().splitlines()[-1])["faults"][0].startswith("the output")


def _multihost_res(**change) -> dict:
    hosts = [{"exit": 0, "killed": False, "stderr_tail": "", "wrote_bytes": 9 if i == 0 else 0, "faults": [],
              "scheduler_stats": {"abandoned_batches": 0}} for i in range(2)]
    res = {"transport": "gloo", "archive_digest": "d", "archive_bytes": 9, "ref_digest": "d", "ref_bytes": 9,
           "host_lines": hosts}
    res.update(change)
    return res


@pytest.mark.parametrize("change, fault", [
    (lambda r: r.update(archive_digest="e"), "multihost gloo host 0: archive e of 9 bytes != REF's d of 9"),
    (lambda r: r["host_lines"][1].update(wrote_bytes=4), "multihost gloo host 1 wrote 4 bytes, where only host 0"),
    (lambda r: r["host_lines"][0].update(exit=1, stderr_tail="Traceback"), "multihost gloo host 0: exit 1: Traceback"),
    (lambda r: r["host_lines"][1].update(exit=-9, killed=True), "multihost gloo host 1: exit -9 (killed at its limit)"),
    (lambda r: r["host_lines"][1]["scheduler_stats"].update(abandoned_batches=2),
     "multihost gloo host 1: 2 abandoned batches"),
    (lambda r: r["host_lines"][0].update(faults=["host 0: fast: MTF launches by width"]),
     "multihost gloo host 0: fast: MTF launches by width"),
], ids=["archive", "host1_wrote", "exit", "killed", "abandoned", "launches"])
def test_multihost_faults_name_the_transport_and_the_host(change, fault):
    res = _multihost_res()
    assert scale_run.multihost_faults(res) == []
    change(res)
    faults = scale_run.multihost_faults(res)
    assert len(faults) == 1 and faults[0].startswith(fault), faults


@pytest.mark.parametrize("mem_gb, free_gb, target, cut_by", [
    (400, 100, 10_000_000_000, None), (96, 100, 4_925_294_117, "memory"), (400, 10, 5_457_241_379, "disk")])
def test_config5_target_takes_what_memory_and_disk_hold(mem_gb, free_gb, target, cut_by):
    """Two hosts of 6.8 GB a GB of BED above a 4.5 GB start within 80% of
    the memory, and the corpus with three archives of 0.15 of it within
    80% of the disk, less one whole chromosome's 60 MB."""
    room = scale_run.config5_target(10_000_000_000, mem_gb * 10**9, free_gb * 10**9, 6800.0, 4500.0, 0.15)
    assert room["cut_by"] == cut_by
    assert room["target"] == pytest.approx(target, abs=2)
    assert room["target"] <= 10_000_000_000


def test_native_runtime_loads_once_for_threads_that_ask_together(monkeypatch):
    """``runtime.get_lib`` asked by 8 threads at once while the library
    loads (as the device leg's transform pool does): every thread gets the
    library, none the None of fallback mode, and it loads once.  Before,
    ``_tried`` was set before the load, so a thread that came meanwhile
    took None."""
    import threading
    import time

    from starch3_tpu_torch import runtime

    loaded = (runtime.get_lib(), runtime._gil_lib, runtime.lib_path)
    assert loaded[0] is not None
    calls = []

    def slow_load():
        calls.append(1)
        time.sleep(0.3)
        return loaded

    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_tried", False)
    monkeypatch.setattr(runtime, "_load", slow_load)
    start, got = threading.Barrier(8), []

    def ask():
        start.wait()
        got.append(runtime.get_lib())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert got == [loaded[0]] * 8 and calls == [1]


def test_device_leg_texts_file_is_written_then_read(small, tmp_path):
    """``device --texts FILE``: the first leg transforms the corpus and
    writes its texts there, a second leg (another mode, untraced) reads
    them back; both hold every stream to the host archive's, and the
    file holds the corpus's chromosomes and the native transform's texts."""
    from starch3_tpu_torch.runtime import bed_transform_native

    d, _gen, _ = small
    texts = tmp_path / "in.texts"
    written = []
    for extra in ([], ["--mode", "rle2", "--untraced"]):
        r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", tmp_path / "trace",
                  tmp_path / "mismatch", "--device", "cpu", "--level", 1, "--texts", texts, *extra],
                 env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        res = json.loads(r.stdout.decode().splitlines()[-1])
        assert res["faults"] == [] and res["streams"] == 3 and res["blocks"] == 6
        written.append((texts.stat().st_ino, texts.stat().st_mtime_ns))
    assert written[0] == written[1], "the second leg wrote the file again"
    chroms, got = scale_run.read_texts(str(texts))
    want = bed_transform_native((d / "in.bed").read_bytes())
    assert chroms == [g[0] for g in want] and [bytes(t) for t in got] == [bytes(g[1]) for g in want]


def test_device_leg_traced_only(small, tmp_path):
    """``device --traced-only`` (reads' (d) in ``chip_smoke.py``): one
    encode, traced, whose figures are the leg's, its trace beside them and
    no timed run; every stream held to the host archive's."""
    d, _gen, _ = small
    r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", tmp_path / "trace",
              tmp_path / "mismatch", "--device", "cpu", "--level", 1, "--traced-only"],
             env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["faults"] == [] and "traced" not in res and res["streams"] == 3
    assert res["blocks"] == res["device_stats"]["blocks"] == 6 and res["device_stats"]["batches"] >= 2
    assert res["trace_start_seconds"] >= 0 and "batches" in res["trace"]
    assert res["reencode"]["calls"] == res["device_stats"].get("tie_reencodes", 0)
    r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", tmp_path / "trace",
              tmp_path / "mismatch", "--untraced", "--traced-only"])
    assert r.returncode == 2 and b"not allowed with" in r.stderr


def test_device_leg_first_streams(small, tmp_path):
    """``device --streams 2`` (phase 15's exact modes on half the
    chromosomes): the first two chromosomes alone, transformed (the texts
    file written whole, all three) and then read from that file, each
    held to the host archive's stream of its chromosome."""
    d, _gen, _ = small
    texts = tmp_path / "in.texts"
    for _ in range(2):
        r = _run(["-m", "starch3_tpu_torch.scale_run", "device", d / "in.bed", d / "host.starch", tmp_path / "trace",
                  tmp_path / "mismatch", "--device", "cpu", "--level", 1, "--untraced", "--streams", 2, "--texts",
                  texts], env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        res = json.loads(r.stdout.decode().splitlines()[-1])
        assert res["faults"] == [] and res["streams"] == res["ref_streams"] == 2
        assert res["blocks"] == res["device_stats"]["blocks"] == 4
        assert len(scale_run.read_texts(str(texts))[0]) == 3


def _config4_chromosomes(tmp_path, n: int = 30_000, target: int = 1_000_000) -> bytes:
    """Config 4's first chromosomes, chr1 of ``n`` intervals, to
    ``target`` bytes: about 560 kB a chromosome at 30,000, two blocks
    at level 1 in chr1."""
    corpus.config4_scale_bed(tmp_path / "c4.bed", target, **_size("config4", n))
    return (tmp_path / "c4.bed").read_bytes()


@pytest.mark.parametrize("entry, use_jax", [("stream", False), ("stream", True), ("bytes", True)],
                         ids=["stream_host", "stream_device", "bytes_device"])
def test_config4_across_chunks_equals_jax_package_bytes(tmp_path, monkeypatch, entry, use_jax):
    """Config 4's unsorted starts carried across 16 kB chunks: the port's
    streaming entry (``compress_bed_stream``, whose carry re-transforms a
    chromosome when it ends), on the host path and on the device path on
    the CPU, and its in-memory device entry (``compress_bed_bytes``, whose
    ``_iter_parse_transform`` joins the partial chunks) give the JAX
    package's ``compress_bed_bytes`` byte for byte."""
    import functools

    bed = _config4_chromosomes(tmp_path)
    assert b"\nchr2\t" in bed and b"\nchr3\t" not in bed and len(bed) > 40 << 14
    cfg = dict(use_jax=use_jax, block_size_100k=1)
    want = jax_api.compress_bed_bytes(bed, JaxEncodeConfig(**cfg))
    if entry == "stream":
        out = io.BytesIO()
        api.compress_bed_stream(io.BytesIO(bed), out, EncodeConfig(**cfg), chunk_bytes=1 << 14, device="cpu")
        got = out.getvalue()
    else:
        monkeypatch.setattr(api, "_iter_parse_transform",
                            functools.partial(api._iter_parse_transform, chunk_bytes=1 << 14))
        got = api.compress_bed_bytes(bed, EncodeConfig(**cfg), device="cpu")
    assert got == want
    from starch3_tpu_torch.format.archive import StarchReader

    meta = StarchReader.from_bytes(got).metadata
    assert len(meta.streams) >= 2 and len(meta.streams[0].block_bit_offsets) >= 2


@pytest.mark.parametrize("entry, use_jax", [("stream", False), ("stream", True), ("bytes", True)],
                         ids=["stream_host", "stream_device", "bytes_device"])
def test_reads_across_chunks_equals_jax_package_bytes(tmp_path, monkeypatch, entry, use_jax):
    """The aligned reads (chr1 of 9,000 reads, 603 kB, and chr2) carried
    across 16 kB chunks: the port's streaming entry on the host path and
    on the device path on the CPU, where every block is bits 5 and ties,
    and its in-memory device entry give the JAX package's
    ``compress_bed_bytes`` byte for byte."""
    import functools

    corpus.reads_scale_bed(tmp_path / "r.bed", 650_000, **_size("reads", 9_000))
    bed = (tmp_path / "r.bed").read_bytes()
    assert b"\nchr2\t" in bed and b"\nchr3\t" not in bed and len(bed) > 40 << 14
    cfg = dict(use_jax=use_jax, block_size_100k=1)
    want = jax_api.compress_bed_bytes(bed, JaxEncodeConfig(**cfg))
    if entry == "stream":
        out = io.BytesIO()
        api.compress_bed_stream(io.BytesIO(bed), out, EncodeConfig(**cfg), chunk_bytes=1 << 14, device="cpu")
        got = out.getvalue()
    else:
        monkeypatch.setattr(api, "_iter_parse_transform",
                            functools.partial(api._iter_parse_transform, chunk_bytes=1 << 14))
        got = api.compress_bed_bytes(bed, EncodeConfig(**cfg), device="cpu")
    assert got == want
    from starch3_tpu_torch.format.archive import StarchReader

    meta = StarchReader.from_bytes(got).metadata
    assert len(meta.streams) == 2 and len(meta.streams[0].block_bit_offsets) >= 3


def test_reads_block_ties_in_both_packages_bwt(tmp_path):
    """One block of the aligned reads at n_max 16,384, bits 5: the port's
    ``bwt_of_batch`` on the packed words and the JAX package's
    ``bwt_sort_fast_mid`` on the same dense symbols give the same
    ``orig_ptr`` and ``ties``, and the block ties: every name shares its
    22-byte ``<instrument>:<run>:<flowcell>:`` start with thousands of
    others, longer than the sort's 23 symbols of context can part."""
    import jax.numpy as jnp
    import torch

    from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid
    from starch3_tpu_torch.parallel import pipeline
    from starch3_tpu_torch.runtime import bed_transform_native

    n_max = 16_384
    corpus.reads_scale_bed(tmp_path / "r.bed", 1, **_size("reads", 2_000))
    block = bytes(bed_transform_native((tmp_path / "r.bed").read_bytes())[0][1])[:n_max - 1000]
    symbols = np.unique(np.frombuffer(block, dtype=np.uint8))
    assert 17 <= symbols.size <= 32  # bits 5
    packed, lens, _, _ = pipeline.pack_batch([block], n_max, 5)
    _, ptr, ties = pipeline.bwt_of_batch(packed, torch.from_numpy(lens), 5, n_max)
    dense = np.zeros(n_max, dtype=np.int32)
    dense[: len(block)] = np.searchsorted(symbols, np.frombuffer(block, dtype=np.uint8))
    _, jptr, jties = bwt_sort_fast_mid(jnp.asarray(dense), jnp.int32(len(block)), n_max, 5)
    assert (int(ptr[0]), int(ties[0])) == (int(jptr), int(jties))
    assert int(ties[0]) > 0


def test_config4_decode_in_both_packages_gives_back_the_unsorted_input(tmp_path):
    """The archive of config 4's chromosomes decodes to the input, starts
    that go back and all, through the JAX package's decode, the port's
    native one and the port's device decode on the CPU (``use_jax=True``):
    the negative deltas are restored."""
    bed = _config4_chromosomes(tmp_path, target=600_000)
    first = [int(line.split(b"\t")[1]) for line in bed.splitlines()[:5000]]
    assert first != sorted(first)
    archive = api.compress_bed_bytes(bed, EncodeConfig(use_jax=False, block_size_100k=1))
    assert jax_api.decompress_starch_bytes(archive) == bed
    assert api.decompress_starch_bytes(archive, use_jax=False) == bed
    assert api.decompress_starch_bytes(archive, use_jax=True, device="cpu") == bed


def test_chr21_bed_is_the_bench_generator():
    """BASELINE config 1's corpus, the port's copy against ``bench.py``'s
    ``make_chr21_bed``."""
    import bench

    assert corpus.chr21_bed() == bench.make_chr21_bed()
    assert corpus.chr21_bed(2_000, seed=3) == bench.make_chr21_bed(2_000, seed=3)


def test_starts_back_counts_the_lines_whose_start_goes_back():
    """Lines of one chromosome, with a remainder column and a last line
    without its newline: the count of starts below the line before's."""
    bed = b"c\t10\t20\tx\nc\t15\t30\ty\nc\t12\t13\tz\nc\t12\t14\tw\nc\t3\t4\tv\nc\t9\t19"
    assert scale_run.starts_back(bed) == 2
    assert scale_run.starts_back(b"c\t1\t2\nc\t1\t3\nc\t5\t6\n") == 0


def test_oneblock_leg_on_the_cpu(tmp_path):
    """``scale_run oneblock`` (config 1's device-only leg) on the CPU at
    20,000 intervals of the chr21 shape: every run's one block on the
    device, its stream equal to ``bz2.compress(text, 9)``; on the CPU the
    wrappers count no launch and the step runs eagerly (no capture)."""
    (tmp_path / "chr21.bed").write_bytes(corpus.chr21_bed(20_000))
    r = _run(["-m", "starch3_tpu_torch.scale_run", "oneblock", tmp_path / "chr21.bed", "--device", "cpu"],
             env=dict(os.environ, STARCH3_TPU_NO_HOST_FALLBACK="1"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    assert res["faults"] == [] and len(res["runs"]) == scale_run.ONEBLOCK_RUNS == 3
    for run in res["runs"]:
        assert run["equal"] and run["blocks"] == 1
        assert run["device_stats"]["blocks_bits4"] == run["device_stats"]["batches"] == 1
        assert not any(run["width_launches"].values()) and not run["device_stats"].get("graph_captures")


@pytest.mark.parametrize("mem_gb, free_gb, target, cut_by", [
    (400, 100, 10_000_000_000, None), (20, 100, 7_304_000_000, "memory"), (400, 20, 5_530_769_230, "disk")])
def test_config4_target_takes_what_memory_and_disk_hold(mem_gb, free_gb, target, cut_by):
    """The device-only leg's 1.5 bytes a byte of BED above a 4,744 MB
    start within 80% of the memory, and the corpus, its sorted twin, the
    1.1e9-byte prefix and four archives of 0.15 of it within 80% of the
    disk, less the largest chromosome's 200 MB."""
    room = scale_run.stated_target("config4", 10_000_000_000, mem_gb * 10**9, free_gb * 10**9)
    assert room["cut_by"] == cut_by
    assert room["target"] == pytest.approx(target, abs=2)


def _config4_legs(prefix_bytes: int = 1_185_546_635) -> dict:
    """``leg_stated``'s legs of config 4 as ``stated_faults`` reads them: the corpus
    and its 1.1e9-byte prefix, (a) at 10 MB/s of text, the hybrids on the
    prefix and the whole, (d) at 120 MB/s with every chromosome's starts
    going back."""
    sched = {"demotions": 0, "repromotions": 0, "abandoned_batches": 0, "class_skips": 0}
    hybrid = {"archive_digest": "x", "scheduler_stats": dict(sched), "peak_rss_mb": 4260.0, "rss_start_mb": 3140.0,
              "max_memory_reserved": 849_346_560, "decode": {"digest": "c", "bytes": 2_382_088_779}}
    return {"gen": {"digest": "c", "bytes": 2_382_088_779}, "gen_prefix": {"bytes": prefix_bytes},
            "a": {"archive_digest": "x", "seconds": 36.0},
            "b_half": dict(hybrid, scheduler_stats=dict(sched), prefix_of_a=True), "b": hybrid,
            "d": {"text_bytes": 360_000_000, "mb_per_s_text": 120.0,
                  "starts_back": {"chroms": 24, "of": 24, "lines": 6_506_995}}}


@pytest.mark.parametrize("change, fault", [
    (None, None),
    (lambda l: l["b"].update(archive_digest="y"), "config4 (b) archive y != host path's x"),
    (lambda l: l["b_half"].update(prefix_of_a=False), "config4 (b) the half archive's streams are not"),
    (lambda l: l["b"].update(decode={"digest": "z", "bytes": 1}), "config4 (e) decode z of 1 bytes"),
    (lambda l: l["b"]["scheduler_stats"].update(demotions=1), "config4 (b) benched the device"),
    (lambda l: l["b_half"]["scheduler_stats"].update(abandoned_batches=1), "config4 (b) half abandoned batches"),
    (lambda l: l["d"].update(starts_back={"chroms": 0, "of": 24, "lines": 0}), "config4 (d) no chromosome's starts"),
    (lambda l: l["b"].update(peak_rss_mb=4500.0), "config4 (f) memory grew with the corpus"),
    (lambda l: (l["b"].update(peak_rss_mb=4500.0), l["gen_prefix"].update(bytes=1_500_000)), None),
], ids=["healthy", "archive", "prefix", "decode", "demotion", "abandoned", "sorted", "memory", "memory_tiny_prefix"])
def test_config4_faults(change, fault):
    """``scale_run config4``'s gates: each fails the run with one message;
    the memory bound holds from the 1.1e9-byte prefix, not from a tiny
    one, where the encode's memory has not levelled off."""
    legs = _config4_legs()
    if change:
        change(legs)
    faults = scale_run.stated_faults("config4", legs)
    assert faults == [] if fault is None else (len(faults) == 1 and faults[0].startswith(fault)), faults


@pytest.mark.parametrize("mem_gb, free_gb, target, cut_by", [
    (400, 100, 10_000_000_000, None), (20, 100, 5_508_000_000, "memory"), (400, 10, 4_638_620_689, "disk")])
def test_stated_target_of_reads(mem_gb, free_gb, target, cut_by):
    """The reads' run: the device-only leg's 2 bytes a byte of BED above a
    4,744 MB start within 80% of the memory, and the corpus, the
    1.1e9-byte prefix and three archives of 0.15 of it (no sorted twin)
    within 80% of the disk, less chr1's 120 MB at most."""
    room = scale_run.stated_target("reads", 10_000_000_000, mem_gb * 10**9, free_gb * 10**9)
    assert room["cut_by"] == cut_by
    assert room["target"] == pytest.approx(target, abs=2)


@pytest.mark.parametrize("change, fault", [
    (None, None),
    (lambda l: l["b"]["scheduler_stats"].update(demotions=1), None),
    (lambda l: (l["b"]["scheduler_stats"].update(demotions=1), l["d"].update(mb_per_s_text=120.0)),
     "reads (b) benched the device"),
    (lambda l: l["b"].update(archive_digest="y"), "reads (b) archive y != host path's x"),
    (lambda l: l["b"].update(decode={"digest": "z", "bytes": 1}), "reads (e) decode z of 1 bytes"),
    (lambda l: l["b_half"]["scheduler_stats"].update(abandoned_batches=1), "reads (b) half abandoned batches"),
    (lambda l: l["b"].update(peak_rss_mb=4500.0), "reads (f) memory grew with the corpus"),
], ids=["healthy", "benched", "benched_faster", "archive", "decode", "abandoned", "memory"])
def test_stated_faults_of_reads(change, fault):
    """``scale_run reads``' gates: config 4's but the starts that go back,
    by the same rule: with (d) at a quarter of (a)'s MB/s of text, as on
    the card (every block ties and is re-encoded on the driver thread), a
    hybrid that benches the card is printed, not a fault; with (d) faster
    than (a) it is one."""
    legs = _config4_legs()
    del legs["d"]["starts_back"]
    legs["d"]["mb_per_s_text"] = 2.5
    if change:
        change(legs)
    faults = scale_run.stated_faults("reads", legs)
    assert faults == [] if fault is None else (len(faults) == 1 and faults[0].startswith(fault)), faults
