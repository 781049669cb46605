"""The one generator of traffic: a traffic mix is a data file of
parameters (``traffic/<name>.json``) and a configuration names the
writer of its BED; from those and the seed come the run's files, and
the order in which one client's closed loop encodes them.

Parameters: ``pool``, the number of distinct files, taken in turn (the
file of index ``i`` is written from the seed ``[seed, i]``, or from the
seed itself where the pool holds one); ``warm_up_encodes``, the most
encodes of set-up; ``about``, a note.  The generator runs one client in
a closed loop and nothing else, so a mix that names any other parameter
is refused rather than run as something it does not ask for."""

from __future__ import annotations

PARAMETERS = frozenset({"pool", "warm_up_encodes", "about"})


def load(layout, name: str) -> dict:
    """The mix ``traffic/<name>.json``, refused where it names a parameter
    this generator does not read."""
    mix = layout.data("traffic", name)
    unread = sorted(set(mix) - PARAMETERS)
    if unread:
        raise ValueError(f"traffic mix {name!r} names {', '.join(unread)}, which the generator does not read "
                         f"(it reads {', '.join(sorted(PARAMETERS))}: one client, closed loop)")
    return mix


def seed_of(seed: int, index: int, pool: int):
    return seed if pool == 1 else [seed, index]


def files(layout, config: dict, traffic: dict, seed: int) -> list[bytes]:
    """The run's distinct BED files, made in memory."""
    writer = layout.module("corpora", config["writer"])
    pool = int(traffic.get("pool", 1))
    return [b"".join(writer.chunks(config.get("target_bytes"), seed_of(seed, i, pool),
                                   **config.get("writer_args", {})))
            for i in range(pool)]


def order(traffic: dict, k: int) -> int:
    """The index of the file that the ``k``-th encode takes."""
    return k % int(traffic.get("pool", 1))
