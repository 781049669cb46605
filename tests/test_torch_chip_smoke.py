"""``chip_smoke.check_equal`` on the CPU: on a kernel's mismatch it keeps
the input and both outputs and runs both sides again, so that one failed
run on the card tells which side was wrong."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from starch3_tpu_torch import corpus, scale_run

ROOT = Path(__file__).resolve().parent.parent
from starch3_tpu_torch.ops.mtf_narrow import mtf_ranks_narrow_reference


def _seqs():
    return torch.randint(0, 16, (2, 4096), generator=torch.Generator().manual_seed(3), dtype=torch.int32)


def test_equal_outputs_pass():
    seqs = _seqs()
    want = mtf_ranks_narrow_reference(seqs, 16)
    case = (seqs, lambda x: mtf_ranks_narrow_reference(x, 16), lambda x: mtf_ranks_narrow_reference(x, 16))
    assert chip_smoke.check_equal("w16", want.clone(), want, case) == 0


@pytest.mark.parametrize("transient", [True, False], ids=["once", "every call"])
def test_mismatch_saves_the_case_and_reruns_both_sides(tmp_path, monkeypatch, transient):
    """A kernel wrong in its first call only, or in every call: the
    message says whether the rerun repeats the fault, and the plain
    version on the CPU names the wrong side."""
    monkeypatch.setattr(chip_smoke, "BUILD_DIR", tmp_path)
    seqs = _seqs()
    calls = []

    def kernel(x):
        out = mtf_ranks_narrow_reference(x, 16)
        if not calls or not transient:
            out[0, 925] += 0x04000000
        calls.append(1)
        return out

    def plain(x):
        return mtf_ranks_narrow_reference(x, 16)

    got, want = kernel(seqs), plain(seqs)
    with pytest.raises(AssertionError) as exc:
        chip_smoke.check_equal("mtf_narrow w16 (2, 4096)", got, want, (seqs, kernel, plain))
    msg = str(exc.value)
    assert "max |diff| 67108864" in msg and "1 positions" in msg
    assert f"([0, 925], {int(got[0, 925])}, {int(want[0, 925])})" in msg
    assert f"kernel == its first output {not transient}" in msg
    assert f"kernel == plain {transient}" in msg
    assert "plain == its first output True" in msg
    assert "plain on the CPU == first kernel output False, == first plain output True" in msg
    saved = torch.load(tmp_path / "mismatch-mtf_narrow_w16__2__4096_.pt")
    assert torch.equal(saved["seqs"], seqs) and torch.equal(saved["got"], got)
    assert torch.equal(saved["want"], want)


@pytest.mark.parametrize("n", [1, 2])
def test_mesh_launches_expected(n):
    """Phase 11's launch check: each batch's kernel once per mesh entry, at
    the width of its class and mode."""
    stats = {"batches": 7, "batches_bits4": 3, "batches_bits5": 2, "batches_bits6": 1, "batches_bits8": 1}
    assert chip_smoke.mesh_launches_expected(stats, n, "fast") == (
        {16: 3 * n, 32: 2 * n, 64: n}, {128: 0, 256: n})
    assert chip_smoke.mesh_launches_expected(stats, n, "fast_huff") == (
        {16: 0, 32: 0, 64: 0}, {128: 3 * n, 256: 4 * n})
    for mode in ("ranks", "rle2"):
        assert chip_smoke.mesh_launches_expected(stats, n, mode) == ({16: 0, 32: 0, 64: 0}, {128: 0, 256: 7 * n})


def _scale_legs(shape: str, demotions: int = 0, device_mb_s: float = 100.0, exact_hybrids: bool = False) -> dict:
    """One tier's legs as phases 13 to 15 read them: 700 MB of text, the
    host path 10 s (70 MB/s of text), hybrids whose card took 9 batches
    of bits 5 (27 blocks, 9 of them tied) and which wrote the host path's
    archive, the device-only runs 60 batches each, 55 in the traced
    window, where the tier runs them; a half run and a pipe leg where the
    tier has them; and the
    tier's phase-15 legs: each mode's hybrids (as fast mode's) and its
    untraced device-only run at 50 MB/s of text (with the host cores' 140
    MB/s on the same texts where the mode runs a hybrid), and the device
    decode; (h)'s two-host encodes where the tier runs them.  With
    ``exact_hybrids`` the exact modes also run a hybrid on the half
    corpus, as phase 15 did before its cut: the gates hold whatever
    hybrids a mode's legs hold."""
    def counters(batches, sched=None, mode="fast"):
        launches = dict.fromkeys(("16", "32", "64", "128", "256"), 0)
        launches[str(scale_run.mode_width(mode, 5))] = batches
        return {"device_stats": {"batches": batches, "batches_bits5": batches, "blocks": 3 * batches},
                "per_class": {str(c): {"blocks": 3 * batches if c == 5 else 0, "tie_reencodes": batches if c == 5
                                       else 0} for c in scale_run.WIDTH_OF_CLASS},
                "width_launches": launches,
                "scheduler_stats": dict({"demotions": 0, "repromotions": 0, "abandoned_batches": 0,
                                         "class_skips": 0}, **(sched or {}))}

    tier = chip_smoke.SCALE_RUNS[shape]
    hybrid = dict(counters(9, {"demotions": demotions}), archive_digest="x", archive_bytes=500,
                  decode={"digest": "c", "bytes": 1_100}, peak_rss_mb=5000.0, rss_start_mb=4500.0,
                  max_memory_reserved=1_000)
    half = dict(hybrid, peak_rss_mb=4990.0, prefix_of_a=True)
    legs = {"gen": {"digest": "c", "bytes": 1_100},
            "a": {"archive_digest": "x", "archive_bytes": 500, "seconds": 10.0, "text_bytes": 700_000_000},
            "b": hybrid}
    if tier.device_only:  # traced, then timed; or, where the tier's (d) is not timed, its traced run alone
        legs["d"] = dict(counters(60), text_bytes=700_000_000, mb_per_s_text=device_mb_s,
                         **({"traced": dict(counters(60), trace={"batches": 55})} if tier.timed else
                            {"trace": {"batches": 55}}))
    if tier.half:
        legs["b_half"] = half
    if tier.pipe:
        legs["c"] = {"archive_digest": "x"}
    for run in tier.modes:
        if exact_hybrids and run.mode in ("ranks", "rle2"):
            run = run._replace(hybrid=("half",))
        mode = legs.setdefault("modes", {})[run.mode] = {
            "d": dict(counters(60, mode=run.mode), text_bytes=700_000_000, mb_per_s_text=50.0)}
        if run.hybrid:
            mode["d"]["host"] = {"mb_per_s_text": 140.0, "streams_differ": 0}
        for part in run.hybrid:
            mode["b" if part == "whole" else "b_half"] = dict(hybrid if part == "whole" else half,
                                                              **counters(9, {"demotions": demotions}, run.mode))
    for transport in tier.multihost:  # (h): two hosts of 11 chromosomes, 7 device batches of bits 4 each
        legs.setdefault("h", {})[transport] = {
            "transport": transport, "device": "cuda", "archive_digest": "x", "archive_bytes": 500, "hosts": 2,
            "host_lines": [{"exit": 0, "killed": False, "wrote_bytes": 500 if i == 0 else 0, "blocks": 220,
                            "device_stats": {"batches": 7, "batches_bits4": 7, "blocks": 21},
                            "width_launches": {"16": 7, "32": 0, "64": 0, "128": 0, "256": 0},
                            "scheduler_stats": {"demotions": 0, "repromotions": 0, "abandoned_batches": 0,
                                                "class_skips": 0}} for i in range(2)]}
    if shape in corpus.SCALE_UNSORTED:  # config 4: every chromosome's starts go back
        legs["d"]["starts_back"] = {"chroms": 9, "of": 9, "lines": 4_000_000}
    if tier.decode:
        legs["g"] = {"digest": "p", "bytes": 400, "streams": tier.decode, "archive_blocks": 72,
                     "corpus": {"digest": "p", "bytes": 400, "streams": tier.decode},
                     "device_stats": {"decode_blocks": 72, "decode_batches": 9}}
    return legs


@pytest.mark.parametrize("shape", sorted(chip_smoke.SCALE_RUNS))
def test_scale_gates_pass_a_healthy_tier(shape):
    assert chip_smoke.scale_faults(shape, _scale_legs(shape)) == []


@pytest.mark.parametrize("shape, device_mb_s, fails", [
    ("wide8", 100.0, True), ("wide8", 70.0, True), ("wide8", 69.9, False), ("config3", 69.9, False),
    ("config3", 100.0, False), ("bed3", 100.0, True), ("bed3", 69.9, True), ("reads", 70.0, True),
    ("reads", 69.9, False)])
def test_scale_demotion_fails_where_the_card_must_be_kept(shape, device_mb_s, fails):
    """Gate 6: the host path encodes 70 MB/s of text; a hybrid that benched
    the card fails a BED6 tier when the card alone is at least that fast,
    and is only printed when it is slower or, on config3, whose (d) is
    cut, not measured; at bits 4 it always fails."""
    faults = chip_smoke.scale_faults(shape, _scale_legs(shape, demotions=1, device_mb_s=device_mb_s))
    assert bool(faults) == fails
    if fails:
        hybrids = 2 if chip_smoke.SCALE_RUNS[shape].half else 1
        assert len(faults) == hybrids and all("benched the device, which alone encodes" in f for f in faults)
        assert faults[-1].startswith(f"{shape} (b) benched the device")


@pytest.mark.parametrize("shape, fails", [("bed3", True), ("bits6", False)])
def test_scale_gates_want_the_default_on_the_card(shape, fails):
    """Where the tier keeps the card (bits 4), the hybrid (b), the CLI's
    default, must put a block on it; elsewhere a benched card may take
    none."""
    legs = _scale_legs(shape)
    legs["b"]["device_stats"]["blocks"] = 0
    faults = chip_smoke.scale_faults(shape, legs)
    assert faults == ([f"{shape} (b) the default CLI put no block on the card, of its None"] if fails else [])


def test_scale_gates_hold_archives_decode_abandons_trace_and_memory():
    """A differing archive of (b) and of (c), a half archive not a prefix,
    a wrong decode, an abandoned batch, a short traced window and memory
    that grows each fail the tier."""
    legs = _scale_legs("bed3")
    legs["b"] = dict(legs["b"], archive_digest="y", decode={"digest": "z", "bytes": 1_100},
                     max_memory_reserved=1_200, scheduler_stats=dict(legs["b"]["scheduler_stats"], abandoned_batches=1))
    legs["c"] = {"archive_digest": "w"}
    legs["d"]["traced"]["trace"] = {"batches": 49}
    legs["b_half"] = dict(legs["b_half"], prefix_of_a=False)
    faults = chip_smoke.scale_faults("bed3", legs)
    assert [f.split(" ", 2)[1] for f in faults] == ["(b)", "(b)", "(b)", "(f)", "(c)", "(e)", "(d)"]
    assert "not the host archive's first streams" in faults[1] and "abandoned batches" in faults[2]
    assert "max_memory_reserved x1.2000" in faults[3] and "49 batches, fewer than 50" in faults[6]


def test_tier_launches_add_the_hybrids_and_both_device_runs():
    """The kernels line's share of a tier: the MTF launches by width of (b)
    half and whole and of (d)'s traced and timed runs, and of each
    phase-15 mode's hybrids and (d)."""
    legs = _scale_legs("config3")  # its (d) and half are cut: the whole corpus's hybrid alone
    assert chip_smoke.tier_launches(legs) == {"16": 0, "32": 9, "64": 0, "128": 0, "256": 0}
    legs["b_half"] = _scale_legs("bed3")["b_half"]
    legs["d"] = _scale_legs("bits6")["d"]
    legs["d"]["traced"]["width_launches"] = dict(legs["d"]["traced"]["width_launches"], **{"256": 4})
    assert chip_smoke.tier_launches(legs) == {"16": 0, "32": 9 + 9 + 60 + 60, "64": 0, "128": 0, "256": 4}
    assert chip_smoke.tier_launches(_scale_legs("wide8")) == {"16": 0, "32": 9 + 60 + 60, "64": 0, "128": 0,
                                                              "256": 60}
    # reads' (d) is its traced run alone
    assert chip_smoke.tier_launches(_scale_legs("reads")) == {"16": 0, "32": 9 + 60, "64": 0, "128": 0, "256": 0}
    # bed3's fast_huff half and whole, 9 batches each, and three (d) runs of 60; with
    # the exact modes' half hybrids, 9 more each
    assert chip_smoke.tier_launches(_scale_legs("bed3"))["256"] == 2 * 9 + 3 * 60
    assert chip_smoke.tier_launches(_scale_legs("bed3", exact_hybrids=True))["256"] == 4 * 9 + 3 * 60
    # and (h)'s hosts, 7 bits-4 batches in each of two hosts, over gloo and over a manifest directory
    assert chip_smoke.tier_launches(_scale_legs("bed3"))["16"] == 2 * 2 * 7


def _mode_leg(legs, mode, key):
    return legs["modes"][mode][key]


@pytest.mark.parametrize("shape, change, fault", [
    ("bed3", lambda l: _mode_leg(l, "fast_huff", "b").update(archive_digest="y"),
     "bed3 fast_huff (b) archive y != host path's x"),
    ("bed3", lambda l: _mode_leg(l, "ranks", "b_half").update(prefix_of_a=False),
     "bed3 ranks (b) the half archive's streams are not the host archive's first streams"),
    ("bed3", lambda l: _mode_leg(l, "rle2", "b_half")["scheduler_stats"].update(abandoned_batches=2),
     "bed3 rle2 (b) half abandoned batches"),
    ("bed3", lambda l: _mode_leg(l, "fast_huff", "b").update(max_memory_reserved=1_101),
     "bed3 fast_huff (f) memory grew with the corpus: the encode's peak RSS above its start x1.0204 (bound 1.15), "
     "max_memory_reserved x1.1010"),
    ("bed3", lambda l: _mode_leg(l, "fast_huff", "b").update(peak_rss_mb=5064.0),
     "bed3 fast_huff (f) memory grew with the corpus: the encode's peak RSS above its start x1.1510"),
    ("bed3", lambda l: l["g"].update(digest="q"), "bed3 (g) device decode q 400 of 1 streams != the corpus's p 400"),
    ("bed3", lambda l: l["g"].update(streams=2),
     "bed3 (g) device decode p 400 of 2 streams != the corpus's p 400 of 1"),
    ("bed3", lambda l: l["g"]["device_stats"].update(decode_blocks=71),
     "bed3 (g) device decode of 71 blocks != the archive's 72"),
], ids=["archive", "half_prefix", "abandoned", "reserved", "rss", "decode_output", "decode_streams",
        "decode_blocks"])
def test_scale_gates_of_the_other_modes_and_decode(shape, change, fault):
    """Phase 15: each gate on a mode's legs or on the device decode fails
    the tier with one message that names the tier, the mode and the leg."""
    legs = _scale_legs(shape, exact_hybrids=True)
    assert chip_smoke.scale_faults(shape, legs) == []
    change(legs)
    faults = chip_smoke.scale_faults(shape, legs)
    assert len(faults) == 1 and faults[0].startswith(fault), faults


@pytest.mark.parametrize("device_mb_s, fails", [(140.0, True), (139.9, False), (100.0, False)])
def test_scale_mode_demotion_fails_where_that_modes_card_outruns_the_host_cores(device_mb_s, fails):
    """Gate 7 per mode: a ``fast_huff`` hybrid that benched the card fails
    only where ``fast_huff``'s own (d) encodes at least the host cores'
    140 MB/s on the same texts, not where it only beats the host path's
    70 MB/s of text, which its feed bounds; ``ranks``' (d) at 50 MB/s may
    be benched."""
    legs = _scale_legs("bed3", exact_hybrids=True)
    for key in ("b_half", "b"):
        _mode_leg(legs, "fast_huff", key)["scheduler_stats"].update(demotions=1)
    _mode_leg(legs, "fast_huff", "d").update(mb_per_s_text=device_mb_s)
    _mode_leg(legs, "ranks", "b_half")["scheduler_stats"].update(demotions=3)
    faults = chip_smoke.scale_faults("bed3", legs)
    assert len(faults) == (2 if fails else 0)
    assert all(f.startswith("bed3 fast_huff (b") and "against the host's 140.000" in f for f in faults)


def _host(legs, transport, i):
    return legs["h"][transport]["host_lines"][i]


@pytest.mark.parametrize("transport", ["gloo", "manifest"])
@pytest.mark.parametrize("change, fault", [
    (lambda l, t: l["h"][t].update(archive_digest="y"),
     "host 0 archive y of 500 bytes != (b) half's x of 500"),
    (lambda l, t: _host(l, t, 1).update(wrote_bytes=3), "host 1 wrote 3 bytes, where only host 0 writes"),
    (lambda l, t: _host(l, t, 1).update(exit=-9, killed=True), "host 1 exit -9 at its limit"),
    (lambda l, t: _host(l, t, 0)["scheduler_stats"].update(abandoned_batches=1), "host 0 abandoned batches"),
    (lambda l, t: _host(l, t, 1).update(device_stats={}, width_launches=dict.fromkeys(
        ("16", "32", "64", "128", "256"), 0)), "host 1 put no block on the card, of its 220"),
    (lambda l, t: _host(l, t, 0)["width_launches"].update({"16": 6}),
     "host 0 fast: MTF launches by width {'16': 6"),
], ids=["archive", "host1_wrote", "exit", "abandoned", "no_device_blocks", "launches"])
def test_scale_gates_of_multihost(transport, change, fault):
    """(h), BASELINE config 5, on bed3's half corpus: each gate on a
    transport's two-host encode fails bed3 with one message that names the
    transport and the host, host 0's archive held to (b)'s half archive; a
    demotion or a class skip in a host is printed, not gated."""
    legs = _scale_legs("bed3")
    assert chip_smoke.scale_faults("bed3", legs) == []
    change(legs, transport)
    faults = chip_smoke.scale_faults("bed3", legs)
    assert len(faults) == 1 and faults[0].startswith(f"bed3 (h) multihost {transport} {fault}"), faults
    legs = _scale_legs("bed3")
    _host(legs, transport, 1)["scheduler_stats"].update(demotions=2, class_skips=5)
    assert chip_smoke.scale_faults("bed3", legs) == []


def test_scale_runs_hold_config4():
    """BASELINE config 4 is a tier of the scale phase: whole chromosomes
    to 1.2e9 bytes (chr1-chr9, the fewest whose (d) traces 50 batches),
    no half corpus and no pipe, a demotion gated by (d)'s rate as on the
    BED6 tiers, and its starts that go back counted."""
    assert chip_smoke.SCALE_RUNS["config4"] == chip_smoke.ScaleTier(
        1_200_000_000, None, pipe=False, keep_card=False)
    assert corpus.SCALE_TIERS["config4"] == 4
    assert corpus.SCALE_UNSORTED == {"config4"}


def test_scale_runs_hold_reads_and_config3s_cut():
    """BASELINE config 3 as aligned reads is a tier of the scale phase:
    whole chromosomes to 2.5e8 bytes (chr1-chr3, the fewest whose (d)
    traces 50 batches), bits 5, no half corpus and no pipe, its (d) its
    traced run alone.
    The config3 tier is cut to its first chromosome (88.4 MB of 2,000,000
    intervals), no half and no (d), and keeps the gate on its hybrid's
    untied blocks on the card; bed3's exact modes encode 11 of its 22
    chromosomes device only and decodes its first on the card (g)."""
    assert chip_smoke.SCALE_RUNS["reads"] == chip_smoke.ScaleTier(250_000_000, None, pipe=False, keep_card=False,
                                                                  timed=False)
    assert [t for t, tier in chip_smoke.SCALE_RUNS.items() if not tier.timed] == ["reads"]
    assert corpus.SCALE_TIERS["reads"] == 5
    assert chip_smoke.SCALE_RUNS["config3"] == chip_smoke.ScaleTier(
        80_000_000, None, pipe=False, keep_card=False, device_only=False, untied_on_card=True)
    assert [t for t, tier in chip_smoke.SCALE_RUNS.items() if tier.untied_on_card] == ["config3"]
    assert {r.mode: r.streams for r in chip_smoke.SCALE_RUNS["bed3"].modes} == {"fast_huff": 0, "ranks": 11,
                                                                                "rle2": 11}
    # (g) decodes bits 4's first stream, 20 blocks, and no other tier's
    assert {t: tier.decode for t, tier in chip_smoke.SCALE_RUNS.items() if tier.decode} == {"bed3": 1}


def test_scale_gates_hold_reads_traced_window():
    """Reads' (d), its traced run alone, must hold 50 batches in its
    traced window as a timed tier's traced run must."""
    legs = _scale_legs("reads")
    assert chip_smoke.scale_faults("reads", legs) == []
    legs["d"]["trace"] = {"batches": 49}
    assert chip_smoke.scale_faults("reads", legs) == ["reads (d) the traced window holds 49 batches, fewer than 50"]


@pytest.mark.parametrize("blocks, tied, fault", [
    (27, 9, None), (27, 27, "config3 (b) put no untied bits-5 block on the card: 27 blocks there, 27 of them tied"),
    (0, 0, "config3 (b) put no untied bits-5 block on the card: 0 blocks there")], ids=["untied", "all_tied", "none"])
def test_scale_gates_of_config3_want_untied_blocks_on_the_card(blocks, tied, fault):
    """Config3's hybrid must put bits-5 blocks on the card whose rows come
    back untied: the one scale run whose K1 w32 rows make its archive."""
    legs = _scale_legs("config3")
    legs["b"]["per_class"]["5"].update(blocks=blocks, tie_reencodes=tied)
    faults = chip_smoke.scale_faults("config3", legs)
    assert faults == [] if fault is None else (len(faults) == 1 and faults[0].startswith(fault)), faults


@pytest.mark.parametrize("change, fault", [
    (lambda l: l["b"].update(archive_digest="y"), "config4 (b) archive y != host path's x"),
    (lambda l: l["b"].update(decode={"digest": "z", "bytes": 1_100}), "config4 (e) decode {'digest': 'z'"),
    (lambda l: l["d"]["starts_back"].update(chroms=8),
     "config4 (d) the starts go back in 8 chromosomes of 9, not in every one"),
    (lambda l: l["d"].pop("starts_back"), "config4 (d) the starts go back in None chromosomes of None"),
], ids=["archive", "decode", "some_sorted", "not_counted"])
def test_scale_gates_of_config4(change, fault):
    """Config 4's tier: a differing archive or decode, or a chromosome
    whose starts never go back, fails it with one message."""
    legs = _scale_legs("config4")
    assert chip_smoke.scale_faults("config4", legs) == []
    change(legs)
    faults = chip_smoke.scale_faults("config4", legs)
    assert len(faults) == 1 and faults[0].startswith(fault), faults


def _config1_legs() -> dict:
    """Phase 16's legs as ``phase_config1`` reads them on a card: the CLI's
    default encode put its one block on the card, and three device-only
    runs of the block, warm-up, capture and replay."""
    def run():
        return {"equal": True, "blocks": 1, "width_launches": {"16": 1, "32": 0, "64": 0, "128": 0, "256": 0},
                "device_stats": {"blocks": 1, "blocks_bits4": 1, "batches": 1, "batches_bits4": 1}}

    return {"corpus": {"digest": "c", "bytes": 2_377_972}, "host": {"archive_digest": "x"},
            "decode": {"digest": "c", "bytes": 2_377_972},
            "cli": dict(run(), archive_digest="x", scheduler_stats={"abandoned_batches": 0, "demotions": 0}),
            "oneblock": {"runs": [run() for _ in range(3)]}}


@pytest.mark.parametrize("change, fault", [
    (lambda l: l["cli"].update(archive_digest="y"), "config1 (i) the CLI's default archive y != the host path's x"),
    (lambda l: l["decode"].update(digest="z"), "config1 (i) the archive decodes to z"),
    (lambda l: l["cli"]["scheduler_stats"].update(abandoned_batches=1), "config1 (i) abandoned batches"),
    (lambda l: l["cli"]["width_launches"].update({"16": 0}), "config1 (i) fast: MTF launches by width"),
    (lambda l: l["oneblock"]["runs"][2].update(equal=False),
     "config1 (ii) run 2: the stream != bz2.compress(text, 9)"),
    (lambda l: l["oneblock"]["runs"][0]["device_stats"].update(blocks_bits4=0),
     "config1 (ii) run 0: blocks, blocks on the card at bits 4, batches and K1 w16 launches (1, 0, 1, 1)"),
    (lambda l: l["oneblock"]["runs"].pop(), "config1 (ii) 2 device-only runs"),
], ids=["archive", "decode", "abandoned", "launches", "stream", "off_the_card", "runs"])
def test_config1_gates(change, fault):
    """Phase 16: a differing archive or decode of the CLI's default encode,
    or a device-only run whose stream differs or whose block was not on
    the card, fails the phase with one message."""
    legs = _config1_legs()
    assert chip_smoke.config1_faults(legs) == []
    change(legs)
    faults = chip_smoke.config1_faults(legs)
    assert len(faults) == 1 and faults[0].startswith(fault), faults


def test_phase_config1_on_the_cpu(tmp_path):
    """Phase 16 run on the CPU: the CLI's ``--platform=cpu`` encode of
    chr21 in a process started anew equals the host path's CLI
    (``--platform=host``) and decodes back, and
    the forked device-only leg's runs equal ``bz2.compress``; on the CPU
    no kernel launches."""
    from starch3_tpu_torch import leg_fork

    with leg_fork.LegForker() as forker:
        assert chip_smoke.phase_config1("cpu", forker, device="cpu") == 0


def test_scale_run_config4_passes_its_gates_on_the_cpu(tmp_path):
    """``scale_run config4`` at a tiny target on the CPU: 200,000
    intervals cut to 3e6 bytes, a prefix of half that, its sorted twin; every
    leg runs, each prints its figures, the gates pass (the memory growth
    printed, not gated, below the 1.1e9-byte prefix), and it removes what
    it wrote."""
    r = subprocess.run([sys.executable, "-m", "starch3_tpu_torch.scale_run", "config4", tmp_path / "c4", "--n-total",
                        "200000", "--target", "3e6", "--device", "cpu"],
                       capture_output=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    lines = [json.loads(x) for x in r.stdout.decode().splitlines()]
    res = lines[-1]
    assert res["faults"] == [] and res["room"]["target"] == 3_000_000
    printed = [k for x in lines[1:-1] for k in x]
    assert sorted(printed) == sorted(res["summary"]) == sorted(
        ["gen", "gen_prefix", "gen_sorted", "a", "b_half", "b", "d", "sorted_a", "sorted_d"])
    s = res["summary"]
    assert s["b"]["decode"]["digest"] == s["gen"]["digest"] and s["gen"]["bytes"] >= 3_000_000
    assert s["d"]["starts_back"]["chroms"] == s["d"]["starts_back"]["of"] > 1
    assert s["sorted_d"]["starts_back"]["chroms"] == 0
    assert set(res["transform_seconds"]) == {"a", "d"} and len(res["memory_growth"]) == 2
    assert os.listdir(tmp_path / "c4") == []


def test_scale_run_reads_passes_its_gates_on_the_cpu(tmp_path):
    """``scale_run reads`` at a tiny target on the CPU: 200,000 reads cut
    to 3e6 bytes (chr1-chr3) and a prefix of half that; every leg runs and
    prints its figures, the gates pass, and it removes what it wrote.
    Every block is bits 5 and ties, so (d) re-encodes each on the
    driver's thread (``s3tdevice``), and its streams equal
    ``bz2.compress``; no sorted twin."""
    r = subprocess.run([sys.executable, "-m", "starch3_tpu_torch.scale_run", "reads", tmp_path / "r", "--n-total",
                        "200000", "--target", "3e6", "--device", "cpu"],
                       capture_output=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    lines = [json.loads(x) for x in r.stdout.decode().splitlines()]
    res = lines[-1]
    assert res["leg"] == "reads" and res["faults"] == [] and res["room"]["target"] == 3_000_000
    printed = [k for x in lines[1:-1] for k in x]
    assert sorted(printed) == sorted(res["summary"]) == sorted(["gen", "gen_prefix", "a", "b_half", "b", "d"])
    s = res["summary"]
    assert s["b"]["decode"]["digest"] == s["gen"]["digest"] and s["gen"]["bytes"] >= 3_000_000
    d = s["d"]
    assert d["blocks_by_class"] == d["tie_reencodes"] == {"5": d["blocks"]} and d["blocks"] >= 3
    assert d["reencode"]["calls"] == d["blocks"] and set(d["reencode"]["by_thread"]) == {"s3tdevice"}
    assert d["bz2"]["streams_differ"] == 0 and d["starts_back"]["chroms"] == 0
    assert "transform_seconds" not in res and len(res["memory_growth"]) == 2
    assert os.listdir(tmp_path / "r") == []
