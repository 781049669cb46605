"""The port's multi-host layer (``starch3_tpu_torch/parallel/distributed.py``,
``parallel/assemble.py`` and the CLI's ``--num-hosts`` branch) on the CPU,
mirroring ``tests/test_parallel.py`` (sharding, manifest) and
``tests/test_multihost.py`` (separate processes).

Each "host" is a real subprocess that imports only ``starch3_tpu_torch``
and runs on ``device="cpu"`` or ``--platform=cpu``.  Processes meet over a
gloo process group (``torch.distributed``) on a free localhost port, or
through a manifest directory.  Every archive must equal the single-process
one byte for byte, and the JAX package's.  Every child has a timeout and is
killed if it is still alive when its test ends."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from starch3_tpu import api as jax_api
from starch3_tpu_torch import api
from starch3_tpu_torch.bed.parser import parse_bed
from starch3_tpu_torch.config import CompressionMethod, EncodeConfig
from starch3_tpu_torch.parallel import pipeline
from starch3_tpu_torch.parallel.assemble import Manifest, assemble_ordered, input_digest
from starch3_tpu_torch.parallel.distributed import (
    corpus_fingerprint,
    encode_corpus_multihost,
    gather_results_manifest,
    process_topology,
    shard_chromosomes,
)
from starch3_tpu_torch.parallel.mesh import make_block_mesh

from tests.conftest import make_bed_text

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120  # a child still running then is killed and fails its test
# children import torch only: one thread each keeps them light beside the
# other test workers
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}

# every worker refuses any module of the JAX package or JAX itself
PRELUDE = r"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "starch3_tpu"):
            raise ImportError("a port worker imported " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_all(cmds, timeout=TIMEOUT_S) -> list[tuple[int, bytes, bytes]]:
    """Start every command at once and wait for all: (returncode, stdout,
    stderr) of each.  A child still alive at the end is killed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=ENV, cwd=ROOT) for c in cmds]
    try:
        out = []
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append((p.returncode, so, se))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _worker(tmp_path, name: str, body: str) -> str:
    path = tmp_path / name
    path.write_text(PRELUDE.format(repo=str(ROOT)) + body)
    return str(path)


def _ok(runs) -> None:
    for rc, _out, err in runs:
        assert rc == 0, err.decode()[-3000:]


# ------------------------------------------------------------- in process


class TestMultihostSharding:
    def test_round_robin(self):
        chroms = [f"chr{i}" for i in range(10)]
        all_assigned = []
        for h in range(3):
            all_assigned += shard_chromosomes(chroms, 3, h)
        assert sorted(all_assigned) == list(range(10))

    def test_topology_without_a_group(self):
        assert process_topology() == (1, 0)

    @pytest.mark.parametrize("on_device", [False, True])
    def test_host_count_invariance(self, rng, on_device):
        """Archive bytes do not depend on how many hosts encoded, on the
        host tier and on the device path (a mesh of 2 ``cpu`` entries)."""
        bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2", "chr3", "chrX"))
        blocks = parse_bed(bed)
        order = [b.chrom for b in blocks]
        cfg = EncodeConfig(use_jax=on_device)
        mesh = make_block_mesh(devices=["cpu", "cpu"]) if on_device else None
        archives = []
        for n_hosts in (1, 2, 4):
            results = {}
            for h in range(n_hosts):
                results.update(encode_corpus_multihost(blocks, cfg, num_hosts=n_hosts, host_id=h, mesh=mesh))
            archives.append(assemble_ordered(order, results))
        assert archives[0] == archives[1] == archives[2]
        assert archives[0] == api.compress_bed_bytes(bed) == jax_api.compress_bed_bytes(bed)
        assert api.decompress_starch_bytes(archives[0]) == bed

    def test_host_count_invariance_gzip_segmented(self, rng):
        cfg = EncodeConfig(method=CompressionMethod.GZIP, gzip_segment_bytes=1024)
        bed = make_bed_text(rng, n=1200, chroms=("chr1", "chr2", "chr3"))
        blocks = parse_bed(bed)
        order = [b.chrom for b in blocks]
        archives = []
        for n_hosts in (1, 3):
            results = {}
            for h in range(n_hosts):
                results.update(encode_corpus_multihost(blocks, config=cfg, num_hosts=n_hosts, host_id=h))
            archives.append(assemble_ordered(order, results, compression="gzip"))
        assert archives[0] == archives[1]
        assert archives[0] == api.compress_bed_bytes(bed, cfg)
        assert api.decompress_starch_bytes(archives[0]) == bed

    def test_fingerprint_stable(self, rng):
        from starch3_tpu.parallel.distributed import corpus_fingerprint as jax_fingerprint

        texts = [bytes(rng.integers(0, 255, 100, dtype=np.uint8)) for _ in range(3)]
        assert corpus_fingerprint(texts) == corpus_fingerprint(list(texts)) == jax_fingerprint(texts)


class TestManifestResume:
    def test_resume_skips_done(self, tmp_path):
        path = str(tmp_path / "manifest.jsonl")
        m = Manifest.load(path)
        digest = input_digest(b"some transformed text")
        assert not m.has("chr1", digest)
        m.record("chr1", digest, "chr1.bz2", {"size": 10})
        m2 = Manifest.load(path)  # the entry survives the "crash"
        assert m2.has("chr1", digest)
        assert not m2.has("chr1", input_digest(b"different text"))


def test_device_huffman_and_mesh_forwarded(rng, monkeypatch):
    """``encode_corpus_multihost`` forwards ``device_huffman``, the mesh and
    the device to the pipeline, and stays byte-identical."""
    seen = []
    real = pipeline.encode_streams

    def record(texts, **kw):
        seen.append(kw)
        return real(texts, **kw)

    monkeypatch.setattr(pipeline, "encode_streams", record)
    bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2"))
    blocks = parse_bed(bed)
    mesh = make_block_mesh(devices=["cpu", "cpu"])
    results = encode_corpus_multihost(
        blocks, config=EncodeConfig(use_jax=True, device_huffman=True), num_hosts=1, host_id=0, mesh=mesh,
        device="cpu",
    )
    order = [b.chrom for b in blocks]
    assert assemble_ordered(order, {c: results[c] for c in order}) == api.compress_bed_bytes(bed)
    assert len(seen) == 1
    assert seen[0]["device_huffman"] is True and seen[0]["mesh"] is mesh and seen[0]["device"] == "cpu"


def test_multihost_needs_a_transport(rng):
    """Two hosts with neither a process group nor a manifest directory:
    the reference's refusal."""
    from starch3_tpu_torch.parallel.distributed import compress_bed_bytes_multihost

    with pytest.raises(ValueError, match="needs manifest_dir"):
        compress_bed_bytes_multihost(make_bed_text(rng, n=60), num_hosts=2, host_id=0)


# ------------------------------------------------------------- processes

WORKER = r"""
import json, os
from starch3_tpu_torch.bed.parser import parse_bed
from starch3_tpu_torch.config import EncodeConfig
from starch3_tpu_torch.parallel.distributed import encode_corpus_multihost

host_id, n_hosts, bed_path, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
blocks = parse_bed(open(bed_path, "rb").read())
results = encode_corpus_multihost(blocks, EncodeConfig(use_jax=True), num_hosts=n_hosts, host_id=host_id,
                                  device="cpu")
manifest = {}
for chrom, (stream, stats) in results.items():
    path = os.path.join(out_dir, f"{chrom}.stream")
    open(path, "wb").write(stream)
    manifest[chrom] = {"path": path, "stats": stats}
open(os.path.join(out_dir, f"host{host_id}.json"), "w").write(json.dumps(manifest))
"""


def test_two_process_encode_matches_single(tmp_path, rng):
    """Two processes each encode their share on the device path; host-0
    assembly of their streams equals the single-process archive."""
    bed = make_bed_text(rng, n=1200, chroms=("chr1", "chr2", "chr3", "chr4", "chrM"))
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    worker = _worker(tmp_path, "worker.py", WORKER)
    _ok(_run_all([[sys.executable, worker, str(h), "2", str(bed_path), str(tmp_path)] for h in range(2)]))
    order = [b.chrom for b in parse_bed(bed)]
    results = {}
    for h in range(2):
        for chrom, entry in json.loads((tmp_path / f"host{h}.json").read_text()).items():
            results[chrom] = (Path(entry["path"]).read_bytes(), entry["stats"])
    assert set(results) == set(order)
    archive = assemble_ordered(order, results)
    assert archive == api.compress_bed_bytes(bed) == jax_api.compress_bed_bytes(bed)
    assert api.decompress_starch_bytes(archive) == bed


DIST_WORKER = r"""
import os
host_id, n_hosts, port, bed_path, out_dir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
from starch3_tpu_torch.config import EncodeConfig
from starch3_tpu_torch.parallel.distributed import (
    compress_bed_bytes_multihost, initialize_distributed, process_topology, shutdown_distributed)
from starch3_tpu_torch.parallel.mesh import make_block_mesh
initialize_distributed(f"127.0.0.1:{port}", n_hosts, host_id)
try:
    assert process_topology() == (n_hosts, host_id), process_topology()
    mesh = make_block_mesh(devices=["cpu"] * 4)
    archive = compress_bed_bytes_multihost(open(bed_path, "rb").read(), EncodeConfig(use_jax=True), mesh=mesh)
finally:
    shutdown_distributed()
assert process_topology() == (1, 0)
open(os.path.join(out_dir, f"archive{host_id}.starch"), "wb").write(archive)
"""


def test_two_process_gloo_gather(tmp_path, rng):
    """A real gloo process group: 2 processes, each encoding its
    chromosome share on a mesh of 4 ``cpu`` entries, the streams gathered
    with ``all_gather``.  Every process ends with the single-process
    archive."""
    bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2", "chr3", "chrX"))
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    worker = _worker(tmp_path, "dworker.py", DIST_WORKER)
    port = str(_free_port())
    _ok(_run_all([[sys.executable, worker, str(h), "2", port, str(bed_path), str(tmp_path)] for h in range(2)]))
    single = api.compress_bed_bytes(bed)
    assert single == jax_api.compress_bed_bytes(bed)
    for h in range(2):
        assert (tmp_path / f"archive{h}.starch").read_bytes() == single, f"host {h} archive differs"


@pytest.mark.parametrize("transport", ["manifest", "gloo"])
def test_cli_multihost(tmp_path, rng, transport):
    """One CLI process per host (``--jax --platform=cpu``), through a
    manifest directory or a gloo process group: host 0's stdout is the
    single-process CLI's archive and host 1 writes nothing."""
    bed = make_bed_text(rng, n=700, chroms=("chr1", "chr2", "chr3", "chr9", "chrM"))
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    how = f"--manifest-dir={tmp_path / 'manifest'}" if transport == "manifest" else f"--coordinator=127.0.0.1:{_free_port()}"
    cli = [sys.executable, "-m", "starch3_tpu_torch.cli"]
    runs = _run_all(
        [cli + ["--jax", "--platform=cpu", "--num-hosts=2", f"--host-id={h}", how, str(bed_path)] for h in range(2)]
        + [cli + [str(bed_path)]]
    )
    _ok(runs)
    (_, out0, _), (_, out1, _), (_, single, _) = runs
    assert out0 == single == jax_api.compress_bed_bytes(bed)
    assert out1 == b""
    assert api.decompress_starch_bytes(out0) == bed


CRASH_WORKER = r"""
import os
host_id, n_hosts, bed_path, mdir, crash_after = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]))
import starch3_tpu_torch.api as api
calls = {"n": 0}
orig = api._compress_stream_ex
def counting(text, config, workers=None, device="cuda"):
    if calls["n"] >= crash_after >= 0:
        os._exit(9)   # simulated mid-corpus crash: no cleanup, no flush
    calls["n"] += 1
    return orig(text, config, workers, device)
api._compress_stream_ex = counting  # distributed.py imports it at call time
import starch3_tpu_torch.parallel.distributed as D
from starch3_tpu_torch.bed.parser import parse_bed
blocks = parse_bed(open(bed_path, "rb").read())
D.encode_corpus_multihost(blocks, num_hosts=n_hosts, host_id=host_id, manifest_dir=mdir)
sys.stdout.write(str(calls["n"]))
"""


def test_interrupted_encode_resumes_from_manifest(tmp_path, rng):
    """Kill a worker mid-corpus (a hard exit after 2 streams), rerun it:
    the resume re-encodes only the missing chromosomes and the archive
    equals the uninterrupted one."""
    chroms = ("chr1", "chr2", "chr3", "chr4", "chr5", "chr6")
    bed = make_bed_text(rng, n=900, chroms=chroms)
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    mdir = str(tmp_path / "manifest")
    worker = _worker(tmp_path, "cworker.py", CRASH_WORKER)
    [(rc, _, err)] = _run_all([[sys.executable, worker, "0", "1", str(bed_path), mdir, "2"]])
    assert rc == 9, err.decode()[-2000:]
    [(rc, out, err)] = _run_all([[sys.executable, worker, "0", "1", str(bed_path), mdir, "-1"]])
    assert rc == 0, err.decode()[-2000:]
    assert out.decode() == str(len(chroms) - 2), out
    order = [b.chrom for b in parse_bed(bed)]
    archive = assemble_ordered(order, gather_results_manifest(mdir, order, num_hosts=1, timeout_s=5))
    assert archive == api.compress_bed_bytes(bed)
    assert api.decompress_starch_bytes(archive) == bed


SKEW_WORKER = r"""
import json, os, tracemalloc
host_id, n_hosts, port, bed_path, out_dir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
from starch3_tpu_torch.bed.parser import parse_bed
from starch3_tpu_torch.parallel.assemble import assemble_ordered
from starch3_tpu_torch.parallel.distributed import (
    encode_corpus_multihost, gather_results_dist, initialize_distributed, shutdown_distributed)
initialize_distributed(f"127.0.0.1:{port}", n_hosts, host_id)
try:
    blocks = parse_bed(open(bed_path, "rb").read())
    order = [b.chrom for b in blocks]
    results = encode_corpus_multihost(blocks, num_hosts=n_hosts, host_id=host_id)
    gather_results_dist(results, order)  # warm-up
    tracemalloc.start()
    gathered = gather_results_dist(results, order)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
finally:
    shutdown_distributed()
total = sum(len(s) for s, _ in gathered.values())
open(os.path.join(out_dir, f"skew{host_id}.starch"), "wb").write(assemble_ordered(order, gathered))
open(os.path.join(out_dir, f"skew{host_id}.json"), "w").write(json.dumps({"peak": peak, "total_streams": total}))
"""


def test_gather_memory_bounded_with_skewed_streams(tmp_path, rng):
    """Skewed shares (one big chromosome, several small ones) over gloo:
    both archives equal the single-process one, and the gather's peak of
    Python allocations stays O(archive), as the reference's bound says."""
    big = make_bed_text(rng, n=20000, chroms=("chr1",))
    small = make_bed_text(rng, n=400, chroms=("chr2", "chr3", "chr4", "chr5", "chrM"))
    bed = big + small
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    worker = _worker(tmp_path, "sworker.py", SKEW_WORKER)
    port = str(_free_port())
    _ok(_run_all([[sys.executable, worker, str(h), "2", port, str(bed_path), str(tmp_path)] for h in range(2)]))
    single = api.compress_bed_bytes(bed)
    for h in range(2):
        assert (tmp_path / f"skew{h}.starch").read_bytes() == single
        st = json.loads((tmp_path / f"skew{h}.json").read_text())
        assert st["peak"] < 8 * st["total_streams"] + (1 << 20), st
