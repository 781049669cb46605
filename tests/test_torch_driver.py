"""The port's device driver under a slow, dead or recovering device, on the
CPU: the fault handling of ``starch3_tpu_torch/parallel/pipeline.py``
(demotion, recovery probes, stuck-batch abandonment, the no-fallback lane
and the per-class rate cache) against the JAX package's semantics.

``_dispatch_chunk`` is replaced by a mock device that builds exact rows of
the bits 4-6 tiers with the native BWT and MTF, packed as the device steps
pack them,
and hands back the port's handle format ``((rows, event), aux)``.  Its
event's ``query()`` and ``synchronize()`` play a device that runs batches
one after another, or one that never finishes some of them.  Every test
checks exact bytes and the scheduler's counts, and makes no assertion on
wall-clock time; each encode runs in a thread joined with a timeout."""

import bz2
import os
import threading
import time

import numpy as np
import pytest
import torch

from starch3_tpu_torch import runtime
from starch3_tpu_torch.codec import encoder as enc_mod
from starch3_tpu_torch.parallel import host, pipeline

WATCHDOG_S = 60  # an encode that has not ended by then fails the test
ALPHABET = np.frombuffer(b"0123456789p-\t\n", np.uint8)  # 14 symbols: the bits-4 tier


def _texts(rng, n):
    return [ALPHABET[rng.integers(0, ALPHABET.size, 30_000)].tobytes() for _ in range(n)]


def _rows(block_datas, nm, pad_to):
    """Exact rows ``[orig_ptr, ties=0, packed ranks]`` of a batch of the
    bits 4-6 tiers and its ``aux``, as ``_dispatch_chunk`` makes them:
    eight 4-bit ranks per word at bits 4, ``30 // bits`` of ``bits`` bits
    at bits 5/6 (RLE1's run counts lift a block of this alphabet past 16
    distinct bytes now and then)."""
    n_max, bits = nm
    assert bits in (4, 5, 6)
    per, width = (8, 4) if bits == 4 else (30 // bits, bits)
    n_words = -(-n_max // per)
    lens = np.ones(max(len(block_datas), pad_to or 0), np.int32)
    out = np.zeros((lens.size, 2 + n_words), np.int32)
    useds = []
    for i, data in enumerate(block_datas):
        arr = np.frombuffer(data, np.uint8)
        used = np.bincount(arr, minlength=256) > 0
        u2s = (np.cumsum(used) - 1).astype(np.uint8)
        last, ptr = runtime.bwt_native(arr)
        ranks = runtime.mtf_ranks_native(u2s[last].astype(np.int32), int(used.sum()))
        padded = np.zeros(n_words * per, np.uint32)
        padded[: ranks.size] = ranks
        rp = padded.reshape(n_words, per)
        word = rp[:, 0].copy()
        for k in range(1, per):
            word |= rp[:, k] << (width * k)
        out[i] = np.concatenate([np.asarray([ptr, 0], np.int32), word.view(np.int32)])
        useds.append(used)
        lens[i] = arr.size
    return torch.from_numpy(out), {"useds": useds, "lens": lens, "bits": bits}


class _Event:
    """A batch's completion event: ready from ``ready_at`` on, never if
    it is None (a dead device)."""

    def __init__(self, device, ready_at):
        self.device, self.ready_at = device, ready_at

    def query(self):
        return self.ready_at is not None and time.monotonic() >= self.ready_at

    def synchronize(self):
        if self.ready_at is None:
            raise AssertionError("drained a batch the dead device never delivered")
        wait = self.ready_at - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        with self.device.cond:
            self.device.drained += 1


class FakeDevice:
    """Stands in for ``_dispatch_chunk``: batches run one after another,
    ``delay_s`` each, which is their own time on the device
    (``aux["step_s"]``), and none starts sooner than ``latency_s`` after
    its dispatch (a queue before the step); the first ``dead_first``
    dispatches never finish."""

    def __init__(self, delay_s=0.0, dead_first=0, latency_s=0.0):
        self.delay_s, self.dead_first, self.latency_s = delay_s, dead_first, latency_s
        self.cond = threading.Condition()
        self.busy_until = 0.0
        self.dispatched = 0  # batches
        self.blocks = 0
        self.drained = 0  # batches whose rows the driver took

    def dispatch(self, block_datas, nm, device, pad_to=None, mode="fast"):
        assert mode == "fast", mode  # the rows it builds are fast mode's
        rows, aux = _rows(block_datas, nm, pad_to)
        with self.cond:
            dead = self.dispatched < self.dead_first
            self.dispatched += 1
            self.blocks += len(block_datas)
            ready_at = None
            if not dead:
                start = max(time.monotonic() + self.latency_s, self.busy_until)
                ready_at = self.busy_until = start + self.delay_s
            self.cond.notify_all()
        aux["step_s"] = self.delay_s
        return (rows, _Event(self, ready_at)), aux

    def wait_dispatched(self, k):
        with self.cond:
            assert self.cond.wait_for(lambda: self.dispatched >= k, WATCHDOG_S)


@pytest.fixture
def fake(monkeypatch):
    """Installs a FakeDevice; the test sets its behaviour."""
    assert runtime.get_lib() is not None, "the port's native runtime must build here"
    dev = FakeDevice()
    monkeypatch.setattr(pipeline, "_dispatch_chunk", dev.dispatch)
    # each test starts with no per-class rates of earlier encodes
    monkeypatch.setattr(host, "_class_rate_cache", {})
    return dev


@pytest.fixture
def encode_threads(monkeypatch):
    """Wraps the host block encode: records the name of each thread that
    ran it, and runs ``hooks["before"]`` first, when set."""
    real = enc_mod.encode_block_fragment
    names, hooks = [], {}

    def encode(blk):
        if "before" in hooks:
            hooks["before"]()
        names.append(threading.current_thread().name)
        return real(blk)

    monkeypatch.setattr(enc_mod, "encode_block_fragment", encode)
    return names, hooks


def _encode(feed, **kw):
    """``encode_streams_feed`` on the CPU device in a watchdog thread."""
    box = {}

    def run():
        try:
            box["streams"] = pipeline.encode_streams_feed(feed, device="cpu", **kw)
        except BaseException as e:  # re-raised in the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WATCHDOG_S)
    assert not t.is_alive(), f"the encode did not end within {WATCHDOG_S} s"
    if "error" in box:
        raise box["error"]
    return box["streams"]


def _assert_exact(texts, streams):
    assert len(streams) == len(texts)
    for i, (t, s) in enumerate(zip(texts, streams)):
        assert s.data == bz2.compress(t, 9), i


def _stats_since(before):
    return {k: host.scheduler_stats[k] - v for k, v in before.items()}


def test_slow_device_is_benched(rng, monkeypatch, fake, encode_threads):
    """A device whose drain rate falls below half the stealers' aggregate
    is benched: each batch takes 1 s on the mock device, while the two
    stealers encode a 30 kB block natively; the stealers start once the
    device holds two batches, so the second drain measures the device."""
    _, hooks = encode_threads
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    monkeypatch.setattr(host, "_DEMOTE_MIN_SAMPLES", 1)
    fake.delay_s = 1.0
    hooks["before"] = lambda: fake.wait_dispatched(2)
    texts = _texts(rng, 40)
    before = dict(host.scheduler_stats)
    _assert_exact(texts, _encode(iter(texts), host_assist=True))
    delta = _stats_since(before)
    assert delta["demotions"] >= 1
    assert delta["abandoned_batches"] == 0 and delta["repromotions"] == 0
    assert fake.drained >= 2


class _StartEvent:
    """A mock launch's timing event: ``seconds`` before the batch's own."""

    def __init__(self, seconds):
        self.seconds = seconds

    def elapsed_time(self, _end):
        return self.seconds * 1e3


@pytest.mark.parametrize("marked", [True, False], ids=["first_of_key", "unmarked"])
def test_first_of_key_batches_only_restart_the_clock(rng, monkeypatch, fake, encode_threads, marked):
    """A key's first two batches on a card warm its step up and capture its
    CUDA graph, once; the rule does not rate them.  The mock's first two
    batches take 1 s each, the rest no time, handed back as the launcher
    hands them (``(None, _Launched)``); one stealer at about 1.6 MB/s
    starts once the device holds two batches.  Marked ``first_of_key``,
    the device is not benched; unmarked, the second batch (1 s, rated
    drain to drain) benches it."""
    from concurrent.futures import Future

    _, hooks = encode_threads
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setattr(host, "_DEMOTE_MIN_SAMPLES", 1)
    hooks["before"] = lambda: (fake.wait_dispatched(2), time.sleep(0.05))
    real = fake.dispatch

    def dispatch(block_datas, nm, device, pad_to=None, mode="fast"):
        first = fake.dispatched < 2
        fake.delay_s = 1.0 if first else 0.0
        (rows, event), aux = real(block_datas, nm, device, pad_to, mode)
        done = Future()
        done.set_result((rows, event))
        launched = pipeline._Launched(done)
        launched.start, launched.first_of_key = _StartEvent(aux.pop("step_s")), marked and first
        return (None, launched), aux

    monkeypatch.setattr(pipeline, "_dispatch_chunk", dispatch)
    texts = _texts(rng, 40)
    before = dict(host.scheduler_stats)
    _assert_exact(texts, _encode(iter(texts), host_assist=True))
    delta = _stats_since(before)
    assert delta["abandoned_batches"] == 0
    assert (delta["demotions"] == 0) == marked
    assert fake.drained >= 3


def test_starved_device_is_not_benched(rng, monkeypatch, fake, encode_threads):
    """The drain rate counts the device's own time, not the wait for
    blocks: a device with no delay, fed a text of four level-1 blocks
    after each 0.8 s pause, takes a batch of three, and the one stealer
    (0.05 s a block here, about 1.6 MB/s) the rest.  Counting the pause
    (about 0.4 MB/s for the device) would bench it at the second drain,
    as the reference does on a 1.1 GB hybrid encode."""
    _, hooks = encode_threads
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setattr(host, "_DEMOTE_MIN_SAMPLES", 1)
    hooks["before"] = lambda: time.sleep(0.05)
    texts = [ALPHABET[rng.integers(0, ALPHABET.size, 4 * 99_000)].tobytes() for _ in range(5)]

    def feed():
        for t in texts:
            time.sleep(0.8)
            yield t

    before = dict(host.scheduler_stats)
    streams = _encode(feed(), host_assist=True, level=1)
    assert [s.data for s in streams] == [bz2.compress(t, 1) for t in texts]
    delta = _stats_since(before)
    assert delta["demotions"] == 0 and delta["abandoned_batches"] == 0
    assert fake.drained >= 2


def _paced_texts(rng, n):
    """``n`` texts of four level-1 blocks each, and a feed that yields
    each after a 0.8 s pause."""
    texts = [ALPHABET[rng.integers(0, ALPHABET.size, 4 * 99_000)].tobytes() for _ in range(n)]

    def feed():
        for t in texts:
            time.sleep(0.8)
            yield t

    return texts, feed()


def test_starved_device_with_latency_is_not_benched(rng, monkeypatch, fake, encode_threads):
    """A healthy device whose batches each wait 0.5 s in a queue before a
    step of no time, fed four level-1 blocks after each 0.8 s pause,
    against one stealer at about 1.6 MB/s: each batch finds the pipeline
    dry and drains before the next text, so it is rated by its own time
    (its pack and drain against its device time).  Rated by its latency,
    about 0.6 MB/s, it would be benched at the second drain."""
    _, hooks = encode_threads
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setattr(host, "_DEMOTE_MIN_SAMPLES", 1)
    hooks["before"] = lambda: time.sleep(0.05)
    fake.latency_s = 0.5
    texts, feed = _paced_texts(rng, 5)
    before = dict(host.scheduler_stats)
    streams = _encode(feed, host_assist=True, level=1)
    assert [s.data for s in streams] == [bz2.compress(t, 1) for t in texts]
    delta = _stats_since(before)
    assert delta["demotions"] == 0 and delta["abandoned_batches"] == 0
    assert fake.drained >= 2


def test_probe_repromotes_a_healthy_starved_device(rng, monkeypatch, fake, encode_threads):
    """The same device and feed, its first batch dead: that batch is
    abandoned after ``_ABANDON_S`` and the device benched; the next claim
    is a probe, whose rows come 0.5 s after it while the driver
    host-encodes its blocks.  Rated by its pack against its device time,
    the probe repromotes the device (rated by its wait, about 0.6 MB/s, it
    would not), and the device is not benched again."""
    _, hooks = encode_threads
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setattr(host, "_DEMOTE_MIN_SAMPLES", 1)
    monkeypatch.setattr(host, "_ABANDON_S", 1.0)
    monkeypatch.setattr(host, "_DEMOTE_PROBE_S", 0.0)
    hooks["before"] = lambda: time.sleep(0.05)
    fake.latency_s, fake.dead_first = 0.5, 1
    texts, feed = _paced_texts(rng, 6)
    before = dict(host.scheduler_stats)
    streams = _encode(feed, host_assist=True, level=1)
    assert [s.data for s in streams] == [bz2.compress(t, 1) for t in texts]
    delta = _stats_since(before)
    assert delta["abandoned_batches"] == delta["demotions"] == 1
    assert delta["repromotions"] >= 1


def test_slow_source_is_fed_as_it_arrives(rng, monkeypatch, fake):
    """A source that takes 0.2 s a text: its first blocks reach the queue
    by the time the second text is in, not once the feeder's prefetch
    holds ``width + 2`` texts (4 on two cores)."""
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    asked, first_feed = [], []

    class Queue(host._BlockQueue):
        def feed_blocks(self, blocks, classes):
            if not first_feed:
                first_feed.append(len(asked))
            super().feed_blocks(blocks, classes)

    monkeypatch.setattr(pipeline, "_BlockQueue", Queue)
    texts = _texts(rng, 6)

    def feed():
        for t in texts:
            asked.append(t)
            time.sleep(0.2)
            yield t

    _assert_exact(texts, _encode(feed(), host_assist=False))
    assert first_feed and first_feed[0] <= 2


def test_dead_device_batches_are_abandoned(rng, monkeypatch, fake, encode_threads):
    """A device that never delivers: its stuck batches go back to the
    queue front after ``_ABANDON_S`` and the stealers encode them.  The
    feed holds its last texts until every dispatched batch is abandoned
    (the benched device claims nothing more: no probe is due), so the
    stealers are still alive then."""
    names, hooks = encode_threads
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    monkeypatch.setattr(host, "_ABANDON_S", 0.4)
    monkeypatch.setattr(host, "_DEMOTE_PROBE_S", 60.0)
    fake.dead_first = float("inf")
    hooks["before"] = lambda: fake.wait_dispatched(1)
    texts = _texts(rng, 20)
    before = dict(host.scheduler_stats)

    def feed():
        yield from texts[:10]
        deadline = time.monotonic() + WATCHDOG_S
        while _stats_since(before)["abandoned_batches"] < max(1, fake.dispatched):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        yield from texts[10:]

    _assert_exact(texts, _encode(feed(), host_assist=True))
    delta = _stats_since(before)
    assert delta["abandoned_batches"] == fake.dispatched >= 1
    assert delta["demotions"] >= delta["abandoned_batches"]
    assert delta["repromotions"] == 0
    assert fake.drained == 0
    # re-enqueued, not encoded inline: the driver thread encoded nothing
    assert names and "s3tdevice" not in names


@pytest.mark.parametrize("probe_s", [60.0, 0.5])
def test_dead_device_only_encode_terminates(rng, monkeypatch, fake, encode_threads, probe_s):
    """``host_assist=False`` on a device that never delivers: stuck
    batches are abandoned to the driver, which host-encodes them and the
    rest of the queue while the device is benched.  probe_s=60: no probe
    is due before the end.  probe_s=0.5: probes fire (a host encode takes
    at least 50 ms here, so the queue outlasts the probe period), and each
    probe's wait keeps encoding queued blocks."""
    names, hooks = encode_threads
    monkeypatch.setattr(host, "_ABANDON_S", 0.4)
    monkeypatch.setattr(host, "_DEMOTE_PROBE_S", probe_s)
    fake.dead_first = float("inf")
    hooks["before"] = lambda: time.sleep(0.05)
    texts = _texts(rng, 30)
    before = dict(host.scheduler_stats)
    _assert_exact(texts, _encode(iter(texts), host_assist=False))
    delta = _stats_since(before)
    assert delta["abandoned_batches"] >= 1
    assert delta["repromotions"] == 0
    assert fake.drained == 0
    assert set(names) == {"s3tdevice"}  # no stealer: the driver encoded every block
    probes = fake.dispatched - delta["abandoned_batches"]
    if probe_s == 60.0:
        assert probes == 0
    else:
        assert probes >= 1


def test_no_host_fallback_keeps_blocking_semantics(rng, monkeypatch, fake, encode_threads):
    """``STARCH3_TPU_NO_HOST_FALLBACK=1``: a slow but live device is never
    abandoned, even past ``_ABANDON_S``; the drain blocks and every block
    comes from the device's rows."""
    names, _ = encode_threads
    monkeypatch.setenv("STARCH3_TPU_NO_HOST_FALLBACK", "1")
    monkeypatch.setattr(host, "_ABANDON_S", 0.15)
    fake.delay_s = 0.5
    texts = _texts(rng, 9)
    before = dict(host.scheduler_stats)
    _assert_exact(texts, _encode(iter(texts), host_assist=False))
    delta = _stats_since(before)
    events = ("demotions", "repromotions", "abandoned_batches", "class_skips")
    assert {k: delta[k] for k in events} == dict.fromkeys(events, 0)
    assert delta["steal_n"] == 0  # no stealer: every block came through the device's rows
    assert fake.blocks == len(texts) and fake.drained == fake.dispatched == 3
    assert names == []  # no host encode at all


def test_recovered_device_is_repromoted(rng, monkeypatch, fake, encode_threads):
    """A device dead for its first two batches and healthy afterwards:
    both are abandoned, the next claim is a probe that lands, and the
    device takes batches again."""
    monkeypatch.setattr(host, "_ABANDON_S", 0.3)
    monkeypatch.setattr(host, "_DEMOTE_PROBE_S", 0.0)
    fake.dead_first = 2
    texts = _texts(rng, 24)
    before = dict(host.scheduler_stats)
    _assert_exact(texts, _encode(iter(texts), host_assist=False))
    delta = _stats_since(before)
    assert delta["abandoned_batches"] == 2
    assert delta["repromotions"] >= 1
    assert fake.drained >= 1  # rows of a batch after the repromotion


def test_second_encode_is_seeded_from_the_class_rate_cache(rng, monkeypatch, fake):
    """A drain records its class's rate in ``_class_rate_cache``; the next
    encode's queue starts from it, with ``_CLASS_MIN_SAMPLES`` samples."""
    fake.delay_s = 0.01
    texts = _texts(rng, 12)
    _assert_exact(texts, _encode(iter(texts), host_assist=False))
    cache = dict(host._class_rate_cache)
    assert cache and min(cache.values()) > 0

    seen = []

    class Queue(host._BlockQueue):
        def feed_blocks(self, blocks, classes):
            if not seen:
                seen.append((dict(self.class_rate), dict(self.class_samples)))
            super().feed_blocks(blocks, classes)

    monkeypatch.setattr(pipeline, "_BlockQueue", Queue)
    _assert_exact(texts, _encode(iter(texts), host_assist=False))
    assert seen == [(cache, dict.fromkeys(cache, host._CLASS_MIN_SAMPLES))]


@pytest.mark.parametrize("cores,on_card,want", [
    (8, False, (8, 8)), (8, True, (4, 4)), (32, True, (28, 8)), (6, True, (2, 2)), (2, True, (1, 2)),
    (1, False, (1, 2)),
])
def test_host_threads_leave_cores_to_the_lane_beside_a_card(monkeypatch, cores, on_card, want):
    """On the CPU every core steals, as in the reference; beside a card the
    stealers and the split pool take the cores left after the lane's
    four."""
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    assert pipeline._host_threads(on_card) == want


def test_cpu_encode_starts_a_stealer_per_core(rng, monkeypatch):
    """The CPU device's hybrid starts one stealer per core and splits on
    as many threads (at most 8), as before."""
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    started = []
    real = pipeline._start_host_stealers

    def record(q, *args):
        threads = real(q, *args)
        started.append((len(threads), q.n_stealers))
        return threads

    monkeypatch.setattr(pipeline, "_start_host_stealers", record)
    texts = _texts(rng, 4)
    _assert_exact(texts, _encode(iter(texts), host_assist=True))
    assert started == [(3, 3)]
