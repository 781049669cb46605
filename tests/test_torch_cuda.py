"""On-card tests of the port's CUDA kernel (marker ``cuda``).

They skip without a CUDA card.  On a machine with one, from the root of
the repository (this file imports no JAX, so it runs without the JAX
package's test configuration):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel must equal its plain PyTorch version exactly, count one launch
per call, and refuse what it does not take."""

import pytest
import torch

from starch3_tpu_torch.ops import mtf_narrow
from starch3_tpu_torch.ops.mtf_narrow import (
    mtf_ranks_narrow_batch,
    mtf_ranks_narrow_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("shape", [(1, 4096), (3, 16_384), (2, 131_072)])
def test_kernel_equals_plain(cuda, width, shape):
    gen = torch.Generator().manual_seed(width * 7 + shape[1])
    seqs = torch.randint(0, width, shape, generator=gen, dtype=torch.int32)
    seqs[0, 1] = width - 1
    seqs[-1, -5:] = width + 1  # outside the alphabet: ranks `width`
    seqs = seqs.to(cuda)
    before = mtf_narrow.launches
    got = mtf_ranks_narrow_batch(seqs, width)
    torch.cuda.synchronize()
    assert mtf_narrow.launches == before + 1
    assert torch.equal(got, mtf_ranks_narrow_reference(seqs, width))


def test_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError, match="multiple of 4096"):
        mtf_ranks_narrow_batch(torch.zeros((1, 1000), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mtf_ranks_narrow_batch(torch.zeros((8192, 2), dtype=torch.int32, device=cuda).t())
