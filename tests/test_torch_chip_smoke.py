"""``chip_smoke.check_equal`` on the CPU: on a kernel's mismatch it keeps
the input and both outputs and runs both sides again, so that one failed
run on the card tells which side was wrong."""

import pytest
import torch

import chip_smoke
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


def _scale_legs(shape: str, demotions: int = 0, device_mb_s: float = 100.0) -> dict:
    """One tier's legs as phases 13 and 14 read them: 700 MB of text, the
    host path 10 s (70 MB/s of text), hybrids whose card took 9 batches
    of bits 5, the device-only runs 60 batches each, 55 in the traced
    window; a half run and a pipe leg where the tier has them."""
    def counters(batches, sched=None):
        return {"device_stats": {"batches": batches, "batches_bits5": batches, "blocks": 3 * batches},
                "width_launches": {"16": 0, "32": batches, "64": 0, "128": 0, "256": 0},
                "scheduler_stats": dict({"demotions": 0, "repromotions": 0, "abandoned_batches": 0,
                                         "class_skips": 0}, **(sched or {}))}

    tier = chip_smoke.SCALE_RUNS[shape]
    hybrid = dict(counters(9, {"demotions": demotions}), archive_digest="x",
                  decode={"digest": "c", "bytes": 1_100}, peak_rss_mb=5000.0, rss_start_mb=4500.0,
                  max_memory_reserved=1_000)
    legs = {"gen": {"digest": "c", "bytes": 1_100}, "a": {"archive_digest": "x", "seconds": 10.0}, "b": hybrid,
            "d": dict(counters(60), text_bytes=700_000_000, mb_per_s_text=device_mb_s,
                      traced=dict(counters(60), trace={"batches": 55}))}
    if tier.half:
        legs["b_half"] = dict(hybrid, peak_rss_mb=4990.0)
    if tier.pipe:
        legs["c"] = {"archive_digest": "x"}
    return legs


@pytest.mark.parametrize("shape", sorted(chip_smoke.SCALE_RUNS))
def test_scale_gates_pass_a_healthy_tier(shape):
    assert chip_smoke.scale_faults(shape, _scale_legs(shape)) == []


@pytest.mark.parametrize("shape, device_mb_s, fails", [
    ("wide8", 100.0, True), ("wide8", 70.0, True), ("wide8", 69.9, False), ("config3", 69.9, False),
    ("bed3", 100.0, True), ("bed3", 69.9, True)])
def test_scale_demotion_fails_where_the_card_must_be_kept(shape, device_mb_s, fails):
    """Gate 6: the host path encodes 70 MB/s of text; a hybrid that benched
    the card fails a BED6 tier when the card alone is at least that fast,
    and is only printed when it is slower; at bits 4 it always fails."""
    faults = chip_smoke.scale_faults(shape, _scale_legs(shape, demotions=1, device_mb_s=device_mb_s))
    assert bool(faults) == fails
    if fails:
        hybrids = 2 if chip_smoke.SCALE_RUNS[shape].half else 1
        assert len(faults) == hybrids and all("benched the device, which alone encodes" in f for f in faults)
        assert faults[-1].startswith(f"{shape} (b) benched the device")


def test_scale_gates_hold_archives_decode_abandons_trace_and_memory():
    """A differing archive of (b) and of (c), a half archive not a prefix,
    a wrong decode, an abandoned batch, a short traced window and memory
    that grows each fail the tier."""
    legs = _scale_legs("bed3")
    legs["b"] = dict(legs["b"], archive_digest="y", decode={"digest": "z", "bytes": 1_100},
                     max_memory_reserved=1_200, scheduler_stats=dict(legs["b"]["scheduler_stats"], abandoned_batches=1))
    legs["c"] = {"archive_digest": "w"}
    legs["d"]["traced"]["trace"] = {"batches": 49}
    faults = chip_smoke.scale_faults("bed3", legs, half_prefix=False)
    assert [f.split(" ", 2)[1] for f in faults] == ["(b)", "(c)", "(b)", "(e)", "(b)", "(d)", "(f)"]
    assert "abandoned batches" in faults[4] and "49 batches, fewer than 50" in faults[5]
    assert "max_memory_reserved x1.2000" in faults[6]


def test_tier_launches_add_the_hybrids_and_both_device_runs():
    """The kernels line's share of a tier: the MTF launches by width of (b)
    half and whole and of (d)'s traced and timed runs."""
    legs = _scale_legs("config3")
    legs["d"]["traced"]["width_launches"] = dict(legs["d"]["traced"]["width_launches"], **{"256": 4})
    assert chip_smoke.tier_launches(legs) == {"16": 0, "32": 9 + 9 + 60 + 60, "64": 0, "128": 0, "256": 4}
    assert chip_smoke.tier_launches(_scale_legs("wide8"))["32"] == 9 + 60 + 60
