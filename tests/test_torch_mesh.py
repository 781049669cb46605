"""Block meshes over torch devices (``starch3_tpu_torch/parallel/mesh.py``)
and the device paths under them, on the CPU, against the JAX package.

A mesh of 8 ``cpu`` entries stands for the JAX package's 8 virtual CPU
devices (``tests/conftest.py``): each entry runs the same step on its
slice of every batch.  The splits equal what ``NamedSharding(mesh,
P("blocks"))`` does to a batch's leading axis, and every encode and
decode equals the JAX package's run on its 8-device mesh and
``bz2.compress`` byte for byte (zero tolerance)."""

import bz2

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from starch3_tpu import api as jax_api
from starch3_tpu.codec.encoder import bz2_compress
from starch3_tpu.parallel import mesh as jax_mesh_mod
from starch3_tpu.parallel import pipeline as jax_pipe
from starch3_tpu_torch import api
from starch3_tpu_torch.parallel import mesh as mesh_mod
from starch3_tpu_torch.parallel import pipeline
from starch3_tpu_torch.parallel.mesh import block_sharding, make_block_mesh, pad_batch

from tests.conftest import make_bed_text

AL14 = np.frombuffer(b"0123456789p-\t\n", np.uint8)  # bits 4
AL21 = np.frombuffer(b"0123456789pek_a+-\t\nXY", np.uint8)  # bits 5


@pytest.fixture(scope="module")
def mesh8():
    return make_block_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh_mod.make_block_mesh()


def _texts(rng, n4=9, n5=1, size=9000):
    return [AL14[rng.integers(0, AL14.size, size)].tobytes() for _ in range(n4)] + [
        AL21[rng.integers(0, AL21.size, size)].tobytes() for _ in range(n5)
    ]


class TestMesh:
    def test_mesh_of_cpu_entries(self, mesh8):
        assert mesh8.size == 8
        assert mesh8.axis_names == ("blocks",) == jax_mesh_mod.make_block_mesh().axis_names
        assert mesh8.devices == (torch.device("cpu"),) * 8
        assert mesh8.streams == (None,) * 8

    @pytest.mark.parametrize("n", [1, 4, 8])
    def test_mesh_subset(self, n):
        assert make_block_mesh(n, devices=["cpu"] * 8).size == n == jax_mesh_mod.make_block_mesh(n).devices.size

    def test_mesh_may_name_a_device_twice(self):
        mesh = make_block_mesh(devices=[torch.device("cpu"), "cpu"])
        assert mesh.size == 2 and mesh.devices[0] == mesh.devices[1]

    def test_default_mesh_needs_a_card(self, monkeypatch):
        """No CPU default and no fallback: without a card the default mesh
        and a ``cuda`` entry raise."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            make_block_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            make_block_mesh(devices=["cpu", "cuda:0"])

    def test_mesh_rejects_bad_entries(self):
        with pytest.raises(ValueError, match="unsupported"):
            make_block_mesh(devices=["meta"])
        with pytest.raises(ValueError, match="at least one"):
            make_block_mesh(devices=[])

    @pytest.mark.parametrize("n,k", [(5, 8), (8, 8), (9, 8), (1, 1), (3, 2), (0, 4)])
    def test_pad_batch(self, n, k):
        assert pad_batch(n, k) == jax_mesh_mod.pad_batch(n, k)
        assert pad_batch(n, k) % k == 0 and n <= pad_batch(n, k) < n + k

    @pytest.mark.parametrize("k", [1, 2, 4, 8])
    @pytest.mark.parametrize("n", [8, 16, 24])
    def test_block_sharding_equals_named_sharding(self, n, k):
        """Each entry's rows are the shard that ``NamedSharding(mesh,
        P("blocks"))`` puts on the JAX mesh's device at the same place."""
        jm = jax_mesh_mod.make_block_mesh(k)
        arr = jax.device_put(np.arange(n), NamedSharding(jm, PartitionSpec(jax_mesh_mod.BLOCK_AXIS)))
        by_device = {s.device: s.index[0] for s in arr.addressable_shards}
        want = [by_device[d] for d in jm.devices.flat]
        got = block_sharding(make_block_mesh(devices=["cpu"] * k), n)
        assert [(r.start, r.stop) for r in got] == [(w.start or 0, w.stop or n) for w in want]

    def test_block_sharding_needs_a_multiple(self):
        with pytest.raises(ValueError, match="evenly"):
            block_sharding(make_block_mesh(devices=["cpu"] * 4), 6)

    def test_no_replicated(self):
        """The reference's ``replicated`` has no caller, so no counterpart."""
        assert hasattr(jax_mesh_mod, "replicated") and not hasattr(mesh_mod, "replicated")


def test_encode_streams_8_entries_equals_jax_mesh(rng, mesh8, jax_mesh8):
    """Mirrors ``test_pallas_interpret_under_shard_map_8dev``: the bits 4
    and bits 5 tiers under a mesh of 8 entries, device only.  Batches of 3
    pad to 8 rows, so 5 entries of each batch hold only padding."""
    texts = _texts(rng)
    before = dict(pipeline.device_stats)
    got = pipeline.encode_streams(texts, mesh=mesh8, host_assist=False)
    want = jax_pipe.encode_streams(texts, mesh=jax_mesh8, host_assist=False)
    assert [g.data for g in got] == [w.data for w in want] == [bz2.compress(t, 9) for t in texts]
    assert [g.block_bit_offsets for g in got] == [w.block_bit_offsets for w in want]
    # one batch per claim (3 blocks a batch), whatever the mesh's size
    assert pipeline.device_stats["blocks"] - before["blocks"] == len(texts)
    assert pipeline.device_stats["batches"] - before["batches"] == 4


def test_decode_streams_8_entries_equals_jax_mesh(rng, mesh8, jax_mesh8):
    """Mirrors ``test_decode_streams_mesh_sharded``."""
    texts = [bytes(rng.integers(0, 16, 3000, dtype=np.uint8)) for _ in range(4)]
    streams = [bz2_compress(t, 9) for t in texts]
    before = dict(pipeline.device_stats)
    got = pipeline.decode_streams(streams, mesh=mesh8)
    assert got == jax_pipe.decode_streams(streams, mesh=jax_mesh8) == texts
    assert got == pipeline.decode_streams(streams, device="cpu")  # topology-independent
    assert pipeline.device_stats["decode_batches"] - before["decode_batches"] == 2
    assert pipeline.device_stats["decode_blocks"] - before["decode_blocks"] == 8


def test_archive_decode_8_entries_equals_jax_mesh(rng, mesh8, jax_mesh8):
    bed = make_bed_text(rng, n=3000)
    arc = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))
    got = api.decompress_starch_bytes(arc, use_jax=True, mesh=mesh8)
    assert got == jax_api.decompress_starch_bytes(arc, use_jax=True, mesh=jax_mesh8) == bed


def test_one_block_over_8_entries(rng, mesh8, jax_mesh8):
    """A batch of one block over 8 entries: 7 entries run only padding
    (rows of length 1 in encode, of no symbols in decode)."""
    text = _texts(rng, 1, 0)[0]
    got = pipeline.encode_streams([text], mesh=mesh8, host_assist=False)[0]
    assert got.data == jax_pipe.encode_streams([text], mesh=jax_mesh8, host_assist=False)[0].data
    assert got.data == bz2.compress(text, 9)
    assert pipeline.decode_streams([got.data], mesh=mesh8) == [text]
    assert pipeline.torch_bz2_compress(text, mesh=mesh8) == got.data
    for fast_bwt, device_huffman in ((True, True), (False, False)):
        enc = pipeline.encode_streams([text], mesh=mesh8, host_assist=False, fast_bwt=fast_bwt,
                                      device_huffman=device_huffman)
        assert enc[0].data == got.data


def test_device_encode_blocks_8_entries_equals_jax_mesh(rng, mesh8, jax_mesh8):
    datas = [t[:n] for t, n in zip(_texts(rng, 2, 1), (4000, 1, 3500))]
    got = pipeline.device_encode_blocks(datas, 4096, mesh=mesh8)
    want = jax_pipe.device_encode_blocks(datas, 4096, mesh=jax_mesh8)
    assert len(got) == len(want) == 3
    for (g_used, g_ptr, g_ranks), (w_used, w_ptr, w_ranks) in zip(got, want):
        assert (g_used.tolist(), g_ptr, g_ranks.tolist()) == (w_used.tolist(), w_ptr, w_ranks.tolist())
    assert pipeline.device_encode_blocks([], mesh=mesh8) == []


MODES = {
    "fast": {},
    "fast_huff": {"device_huffman": True},
    "ranks": {"fast_bwt": False},
    "rle2": {"fast_bwt": False, "device_rle2": True},
}


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_under_a_mesh_of_2(rng, mode):
    """Every mode under a mesh of 2 entries: blocks of bits 4, 5 and 8, a
    multi-block stream at level 1 and batches that leave an entry with
    only padding; bytes equal libbz2's."""
    flags = MODES[mode]
    assert pipeline.encode_mode(**{"fast_bwt": True, **flags}) == mode
    texts = _texts(rng, 3, 1, size=5000) + [bytes(rng.integers(0, 200, 4000, dtype=np.uint8))]
    texts.append(AL14[rng.integers(0, AL14.size, 104_000)].tobytes())
    mesh = make_block_mesh(devices=["cpu", "cpu"])
    before = pipeline.device_stats["blocks"]
    got = pipeline.encode_streams(texts, level=1, mesh=mesh, host_assist=False, **flags)
    assert [g.data for g in got] == [bz2.compress(t, 1) for t in texts]
    assert pipeline.device_stats["blocks"] - before == len(texts) + 1


def test_mesh_replaces_the_device_and_the_host_stealers(rng, monkeypatch):
    """Given a mesh, ``device`` is ignored (a ``cuda`` device without a
    card does not raise), and the host stealers default to off, as in the
    reference (``host_assist = mesh is None and ...``)."""
    from starch3_tpu_torch.parallel import host

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    real = host._start_host_stealers

    def record(q, results, errors, host_assist):
        started.append(host_assist)
        return real(q, results, errors, host_assist)

    monkeypatch.setattr(pipeline, "_start_host_stealers", record)
    texts = _texts(rng, 2, 0, size=3000)
    got = pipeline.encode_streams(texts, device="cuda", mesh=make_block_mesh(devices=["cpu"] * 2))
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    assert started == [False]
