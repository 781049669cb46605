"""Block meshes over torch devices: data parallelism over independent
blocks, the counterpart of ``starch3_tpu/parallel/mesh.py``.

The JAX package builds a 1-D ``jax.sharding.Mesh`` over every chip and
shards each batch of blocks on its leading axis; XLA then runs one program
on each chip's shard.  Blocks never exchange state, so there are no
collectives.  Here a mesh is a tuple of torch devices, one per entry, which
may name one device more than once.  A batch is padded to a multiple of the
mesh's size (``pad_batch``) and split into equal, contiguous row ranges in
mesh order (``block_sharding``, what ``NamedSharding(mesh, P("blocks"))``
does to the leading axis).  Each entry runs the same device step on its
slice, on a CUDA stream of its own (two entries on one card run on two
streams), and the drain joins the rows in mesh order.

The reference's ``replicated`` has no caller anywhere in the JAX package,
so it has no counterpart here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

BLOCK_AXIS = "blocks"


@dataclass(frozen=True)
class BlockMesh:
    """The entries of a block mesh, in order: ``devices[i]`` runs rows
    ``block_sharding(mesh, n)[i]`` of every batch, on ``streams[i]`` (a
    CUDA stream of its own, None for a CPU entry)."""

    devices: tuple[torch.device, ...]
    streams: tuple

    axis_names = (BLOCK_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def _entry_device(device) -> torch.device:
    """A mesh entry as a torch device with its index: ``cuda`` needs a
    card and an index below the card count."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh entry {dev} needs a CUDA card but torch.cuda.is_available() is false; "
                "name CPU entries (devices=['cpu'] * n) to run a mesh on the CPU"
            )
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"mesh entry {dev}: only {torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported mesh entry {dev} (use 'cuda:N' or 'cpu')")
    return dev


def make_block_mesh(num_devices: int | None = None, devices=None) -> BlockMesh:
    """A mesh over ``devices`` (default: every card, ``cuda:0`` ..
    ``cuda:{device_count() - 1}``), cut to the first ``num_devices``.
    Without a card the default raises: there is no CPU default, so name
    CPU entries explicitly (``devices=["cpu"] * 8``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_block_mesh() spans the CUDA cards, but torch.cuda.is_available() is false; "
                "pass devices=['cpu'] * n for a mesh on the CPU"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_entry_device(d) for d in devices]
    if num_devices is not None:
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a block mesh needs at least one device")
    streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None for d in devs)
    return BlockMesh(tuple(devs), streams)


def block_sharding(mesh: BlockMesh, n_rows: int) -> list[slice]:
    """The rows of each entry of a batch of ``n_rows`` (a multiple of the
    mesh's size): equal, contiguous ranges in mesh order."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split evenly over {mesh.size} mesh entries")
    per = n_rows // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def pad_batch(n: int, n_devices: int) -> int:
    """Blocks per dispatch must divide evenly across devices."""
    return ((n + n_devices - 1) // n_devices) * n_devices


@contextlib.contextmanager
def on_entry(device: torch.device, stream):
    """Make ``device`` and its entry's ``stream`` current (for a CUDA
    entry), so that the uploads, kernels, copies and events of the step
    enqueue there; a CPU entry needs nothing."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield
