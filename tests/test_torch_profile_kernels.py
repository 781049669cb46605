"""The phase split of ``starch3_tpu_torch/profile_kernels.py --phases``:
the stamps it puts into a copy of a kernel source, checked here on the
text (the copy is built and run only on a CUDA card)."""

import re
from pathlib import Path

import pytest

from starch3_tpu_torch.profile_kernels import PHASE_SOURCE, instrument

ROOT = Path(__file__).resolve().parent.parent

SOURCE = """#include <cuda_runtime.h>

template <int W>
__global__ void __launch_bounds__(128)
other_kernel(int* x) {
  // a. not a rank kernel: no stamps here
  x[0] = W;
}

template <int W>
__global__ void __launch_bounds__(128)
mtf_rank_kernel(const int* __restrict__ seqs, int* out) {
  if (threadIdx.x > 999) return;
  // a. first phase
  {
    out[0] = seqs[0];
  }
  // b. second phase
  out[1] = W;
}

extern "C" int entry() { return 0; }
"""


def test_stamps_at_start_markers_and_end():
    text, names = instrument(SOURCE)
    assert names == ["mtf_rank_kernel: start", "mtf_rank_kernel: a. first phase",
                     "mtf_rank_kernel: b. second phase"]
    body = text[text.index("mtf_rank_kernel(") :]
    stamps = [int(k) for k in re.findall(r"S3T_STAMP\((\d+)\);", body)]
    assert stamps == [0, 1, 2, 3]
    assert body.index("S3T_STAMP(1);") < body.index("// a. first phase")
    assert body.index("S3T_STAMP(2);") < body.index("// b. second phase")
    assert re.search(r"S3T_STAMP\(3\);\n}\n\nextern", body)
    assert "S3T_STAMP(" not in text[text.index("other_kernel(") : text.index("mtf_rank_kernel(")]
    assert text.index("#define S3T_STAMP") > text.index("#include <cuda_runtime.h>")
    assert 'extern "C" int s3t_take_stamps' in text


def test_source_without_rank_kernel_is_refused():
    with pytest.raises(ValueError):
        instrument("#include <cuda_runtime.h>\n__global__ void f() {}\n")


@pytest.mark.parametrize("width", [32, 64, 128, 256])
def test_repo_rank_kernels_are_marked(width):
    """Every width's rank kernels live in csrc/mtf_wide.cu, and each has
    its phases marked: the start, a., b. and the end."""
    src = (ROOT / PHASE_SOURCE).read_text()
    assert f"case {width}: return launch<{width}>(" in src
    text, names = instrument(src)
    assert len(names) == 3
    assert names[1].count("a. ") == 2 and names[2].count("b. ") == 2
    assert text.count("S3T_STAMP(0);") == 2 and text.count("S3T_STAMP(3);") == 2
