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
