"""The comparison that decides ``correct``: every archive of the window,
as its writes' offsets, lengths and SHA-256 (``window.HashSink``), held
to the bytes of the reference's archive of the same file at the same
offsets.  Where an archive differs, the writes that differ are placed
in the reference's layout: which streams, and whether the metadata or
the footer.  Each number compared has the limit 0: the configuration's
guarantee is byte-exact archives."""

from __future__ import annotations

import hashlib

LIMITS = {"encodes_failed": 0, "archives_wrong": 0, "streams_wrong": 0, "metadata_footer_wrong": 0}


def judge(archives, references, failed: int) -> dict:
    """``archives``: ``(file index, HashSink)`` of each encode that
    returned; ``references``: the reference's ``Archive`` of each file.
    Returns each number compared with its limit, in ``LIMITS``' order."""
    wrong = streams = meta = 0
    digests: dict = {}
    for index, sink in archives:
        ref = references[index]
        bad = [] if sink.size == len(ref.data) else [(0, max(sink.size, len(ref.data)))]
        for at, n, digest in sink.writes:
            key = (index, at, n)
            if key not in digests:
                digests[key] = hashlib.sha256(ref.data[at : at + n]).digest()
            if digests[key] != digest:
                bad.append((at, at + n))
        if not bad:
            continue
        wrong += 1
        streams += sum(any(a < hi and b > lo for a, b in bad) for _, lo, hi in ref.streams)
        meta += any(b > ref.metadata[0] for _, b in bad)
    got = {"encodes_failed": failed, "archives_wrong": wrong, "streams_wrong": streams,
           "metadata_footer_wrong": meta}
    return {k: {"value": got[k], "limit": LIMITS[k]} for k in LIMITS}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
