"""Multi-host orchestration on ``torch.distributed``, the counterpart of
``starch3_tpu/parallel/distributed.py``.

BASELINE config 5's multi-host encode, as in the reference:

  - ``initialize_distributed`` joins one process per host to a gloo
    process group (the CLI's ``--coordinator``/``--num-hosts``/
    ``--host-id`` drive it; ``shutdown_distributed`` leaves it);
  - the corpus is sharded by chromosome across hosts with a deterministic
    round-robin over the *input order* (never topology order), so any host
    count yields the same per-chromosome streams;
  - each host encodes its share through the port's device pipeline
    (``parallel/pipeline.encode_streams``) on its ``device`` or local
    ``mesh``: blocks of all its chromosomes share device batches;
  - assembly is an ordered gather: per-stream bytes and stats travel over
    the process group (``gather_results_dist``, gloo's ``all_gather`` of
    CPU tensors) when it is up, or through a shared manifest directory
    otherwise.  Every host ends up with the identical archive bytes; the
    CLI writes it from process 0 only.

On a single host this degrades to the local pipeline.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join this process to a gloo process group at ``coordinator``
    (``host:port``, rank 0 listens there) as rank ``process_id`` of
    ``num_processes``.  No-op without a coordinator address."""
    if coordinator is None:
        return
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )


# backwards-compatible alias (the reference's round-1 name)
maybe_initialize = initialize_distributed


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_topology() -> tuple[int, int]:
    """(num_processes, process_id) of the live process group, or (1, 0)
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def shard_chromosomes(chrom_names: list[str], num_hosts: int, host_id: int) -> list[int]:
    """Deterministic input-order round-robin assignment of chromosome
    indices to hosts (input-derived, never topology-derived)."""
    return [i for i in range(len(chrom_names)) if i % num_hosts == host_id]


def corpus_fingerprint(per_chrom_texts: list[bytes]) -> str:
    """Stable id for a resume manifest namespace."""
    h = hashlib.sha256()
    for t in per_chrom_texts:
        h.update(len(t).to_bytes(8, "little"))
        h.update(hashlib.sha256(t).digest())
    return h.hexdigest()[:16]


def encode_corpus_multihost(
    chrom_blocks,
    config=None,
    num_hosts: int | None = None,
    host_id: int | None = None,
    manifest_dir: str | None = None,
    mesh=None,
    device="cuda",
):
    """Encode this host's chromosome share; returns {chrom: (stream, stats)}.

    The share goes through ``parallel.pipeline.encode_streams`` as ONE
    call (``config.use_jax``, the default: ``EncodeConfig(use_jax=False)``
    asks for the host tier), on ``device`` or on the local ``mesh``, so
    every chromosome's blocks share device batches; the host tier uses the
    shared native thread pool.  With a ``manifest_dir``, streams already
    recorded for this corpus are skipped (idempotent resume;
    parallel/assemble.py).
    """
    from starch3_tpu_torch.api import _compress_stream_ex
    from starch3_tpu_torch.config import CompressionMethod, EncodeConfig
    from starch3_tpu_torch.parallel.assemble import Manifest, input_digest
    from starch3_tpu_torch.transform.delta import transform_chrom

    config = config or EncodeConfig()
    if num_hosts is None or host_id is None:
        num_hosts, host_id = process_topology()
    mine = shard_chromosomes([b.chrom for b in chrom_blocks], num_hosts, host_id)

    manifest = None
    if manifest_dir is not None:
        os.makedirs(manifest_dir, exist_ok=True)
        manifest = Manifest.load(os.path.join(manifest_dir, f"host{host_id}.manifest"))

    transformed = [(i, transform_chrom(chrom_blocks[i])) for i in mine]
    results: dict = {}
    todo = []
    for i, tf in transformed:
        chrom = chrom_blocks[i].chrom
        digest = input_digest(tf.text)
        if manifest is not None and manifest.has(chrom, digest):
            entry = manifest.entries[chrom]
            with open(entry["streamPath"], "rb") as f:
                stream = f.read()
            results[chrom] = (stream, {k: entry[k] for k in _STAT_KEYS})
        else:
            todo.append((chrom, tf, digest))

    def _finish(chrom, tf, digest, stream, offsets):
        stats = dict(
            uncompressed_size=len(tf.text),
            line_count=tf.line_count,
            base_count_nonunique=tf.base_count_nonunique,
            base_count_unique=tf.base_count_unique,
            block_bit_offsets=offsets,
        )
        results[chrom] = (stream, stats)
        if manifest is not None:
            path = os.path.join(manifest_dir, f"{chrom}.stream")
            tmp = path + f".tmp{host_id}"
            with open(tmp, "wb") as f:
                f.write(stream)
            os.replace(tmp, path)
            manifest.record(chrom, digest, path, stats)

    if todo:
        if config.use_jax and config.method is CompressionMethod.BZIP2:
            # one device queue across the whole share: blocks from every
            # chromosome batch together.  Resume granularity is the
            # invocation (the manifest is written as results land).
            from starch3_tpu_torch.parallel.pipeline import encode_streams

            encoded = encode_streams(
                [tf.text for _, tf, _ in todo],
                level=config.block_size_100k,
                device=device,
                mesh=mesh,
                batch_size=config.blocks_per_batch,
                device_rle2=config.device_rle2,
                fast_bwt=config.fast_bwt,
                device_huffman=config.device_huffman,
            )
            for (chrom, tf, digest), e in zip(todo, encoded):
                _finish(chrom, tf, digest, e.data, list(e.block_bit_offsets))
        else:
            # host tier: stream-at-a-time with an immediate manifest
            # record, so a killed worker resumes at the next chromosome
            for chrom, tf, digest in todo:
                stream, offsets = _compress_stream_ex(tf.text, config)
                _finish(chrom, tf, digest, stream, offsets)
    return results


_STAT_KEYS = (
    "uncompressed_size",
    "line_count",
    "base_count_nonunique",
    "base_count_unique",
    "block_bit_offsets",
)


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``t`` (a CPU tensor of one shape on all), in rank
    order: one gloo ``all_gather``."""
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def _all_gather_ragged(data: np.ndarray) -> list[np.ndarray]:
    """Every process's uint8 ``data`` in rank order, whatever their sizes:
    the sizes travel first, then each buffer padded to the largest one (at
    least one byte: gloo moves no empty tensor)."""
    sizes = [int(s) for s in _all_gather(torch.tensor([data.size], dtype=torch.int64))]
    padded = torch.zeros(max(1, max(sizes)), dtype=torch.uint8)
    padded.numpy()[: data.size] = data
    return [t.numpy()[:n] for t, n in zip(_all_gather(padded), sizes)]


def gather_results_dist(results: dict, chrom_order: list[str]) -> dict[str, tuple[bytes, dict]]:
    """All-gather per-chromosome (stream, stats) across the process group,
    the counterpart of the reference's ``gather_results_jax``.

    Collective: every process must call it.  Payload protocol (ragged,
    size-prefixed), as in the reference: each host concatenates ITS
    streams back-to-back in chromosome order into one buffer;
    per-(host, chromosome) lengths travel as one small int64 grid; the
    buffers then move padded to the LARGEST SINGLE HOST'S payload.
    Per-host gather memory is therefore O(total archive bytes) for a
    balanced shard (and O(archive x skew) at worst), never a dense
    [n_chroms, max_stream, n_hosts] grid.
    """
    n_proc, _rank = process_topology()
    if n_proc == 1:
        return dict(results)

    # stats via JSON bytes (ragged-safe)
    blob = json.dumps({c: s for c, (_b, s) in results.items()}, sort_keys=True).encode()
    all_stats: dict[str, dict] = {}
    for b in _all_gather_ragged(np.frombuffer(blob, dtype=np.uint8)):
        all_stats.update(json.loads(b.tobytes().decode() or "{}"))

    # per-(host, chrom) stream lengths: zero for chromosomes owned
    # elsewhere, so a plain cumsum doubles as the packing offsets
    lens = np.zeros(max(1, len(chrom_order)), dtype=np.int64)
    for ci, chrom in enumerate(chrom_order):
        if chrom in results:
            lens[ci] = len(results[chrom][0])
    all_lens = torch.stack(_all_gather(torch.from_numpy(lens))).numpy()[:, : len(chrom_order)]

    # this host's streams, concatenated in chromosome order
    payload = b"".join(results[chrom][0] for chrom in chrom_order if chrom in results)
    all_payloads = _all_gather_ragged(np.frombuffer(payload, dtype=np.uint8))

    # exclusive cumsum per host recovers each stream's offset
    starts = np.zeros_like(all_lens)
    starts[:, 1:] = np.cumsum(all_lens, axis=1)[:, :-1]
    gathered: dict[str, tuple[bytes, dict]] = {}
    for ci, chrom in enumerate(chrom_order):
        owners = np.nonzero(all_lens[:, ci])[0]
        if owners.size == 0:
            raise RuntimeError(f"no host produced stream for {chrom}")
        p = int(owners[0])
        lo = int(starts[p, ci])
        gathered[chrom] = (all_payloads[p][lo : lo + int(all_lens[p, ci])].tobytes(), all_stats[chrom])
    return gathered


def gather_results_manifest(
    manifest_dir: str,
    chrom_order: list[str],
    num_hosts: int,
    timeout_s: float = 600.0,
) -> dict[str, tuple[bytes, dict]]:
    """Gather via a shared manifest directory: wait until every
    chromosome appears in some host's manifest, then load streams.
    The transport without a process group (also the crash-resume path: a
    restarted host appends to its manifest and the gather proceeds)."""
    from starch3_tpu_torch.parallel.assemble import Manifest

    deadline = time.monotonic() + timeout_s
    while True:
        entries: dict[str, dict] = {}
        for h in range(num_hosts):
            path = os.path.join(manifest_dir, f"host{h}.manifest")
            if os.path.exists(path):
                entries.update(Manifest.load(path).entries)
        missing = [c for c in chrom_order if c not in entries]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"streams never appeared for: {missing[:5]}")
        time.sleep(0.2)
    out = {}
    for chrom in chrom_order:
        e = entries[chrom]
        with open(e["streamPath"], "rb") as f:
            stream = f.read()
        out[chrom] = (stream, {k: e[k] for k in _STAT_KEYS})
    return out


def compress_bed_bytes_multihost(
    data: bytes,
    config=None,
    num_hosts: int | None = None,
    host_id: int | None = None,
    manifest_dir: str | None = None,
    mesh=None,
    device="cuda",
) -> bytes:
    """Full multi-host encode: parse, shard, encode this host's share (on
    ``device`` or the local ``mesh``), gather, assemble.  Every
    participating process returns the complete archive bytes (identical
    across hosts and host counts)."""
    from starch3_tpu_torch.bed.parser import parse_bed
    from starch3_tpu_torch.parallel.assemble import assemble_ordered

    blocks = parse_bed(data)
    order = [b.chrom for b in blocks]
    if num_hosts is None or host_id is None:
        num_hosts, host_id = process_topology()
    results = encode_corpus_multihost(
        blocks,
        config=config,
        num_hosts=num_hosts,
        host_id=host_id,
        manifest_dir=manifest_dir,
        mesh=mesh,
        device=device,
    )
    if _dist_live() and num_hosts > 1 and manifest_dir is None:
        gathered = gather_results_dist(results, order)
    elif num_hosts > 1:
        if manifest_dir is None:
            raise ValueError("multi-host without a torch.distributed process group needs manifest_dir")
        gathered = gather_results_manifest(manifest_dir, order, num_hosts)
    else:
        gathered = results
    cfg = config
    note = getattr(cfg, "note", "") if cfg else ""
    comp = getattr(getattr(cfg, "method", None), "value", "bzip2") if cfg else "bzip2"
    return assemble_ordered(order, gathered, note=note, compression=comp)


def _dist_live() -> bool:
    """True when a process group of more than one process is up."""
    return process_topology()[0] > 1
