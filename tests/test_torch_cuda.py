"""The masked top-k kernel on the card, against its plain version.

Marked ``cuda``: these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere. Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Inputs are small multiples of 1/256, so every product and sum is exact in
f32 and the kernel must agree with the plain version bit for bit, exact ties
included.
"""

import pytest
import torch

from lazzaro_tpu_torch.ops import masked_topk as mt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def grid(gen, shape, dtype, device):
    x = torch.randn(shape, generator=gen, device=device)
    return (torch.round(x * 16) / 256).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nq,k", [(4096, 1, 10), (5003, 3, 1), (777, 70, 16),
                                    (20000, 5, 128), (300, 1100, 3),
                                    (20000, 5, 300), (1000, 2, 1000)])
def test_kernel_matches_plain_version(cuda, dtype, n, nq, k):
    gen = torch.Generator(device=cuda).manual_seed(n + nq + k)
    emb = grid(gen, (n, 64), dtype, cuda)
    emb[n // 2:n // 2 + 40] = emb[:40]                       # exact ties
    mask = torch.rand(n, generator=gen, device=cuda) < 0.7
    q = grid(gen, (nq, 64), dtype, cuda)
    before = mt.launches
    s, r = mt.masked_topk(emb, mask, q, k)
    ps, pr = mt.masked_topk_reference(emb, mask, q, k)
    torch.cuda.synchronize()
    assert mt.launches == before + 1
    assert torch.equal(r, pr)
    assert torch.equal(s, ps)


def test_fewer_live_rows_than_k(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    emb = grid(gen, (1000, 32), torch.bfloat16, cuda)
    mask = torch.zeros(1000, dtype=torch.bool, device=cuda)
    mask[[3, 500, 999]] = True
    q = grid(gen, (2, 32), torch.bfloat16, cuda)
    s, r = mt.masked_topk(emb, mask, q, 8)
    ps, pr = mt.masked_topk_reference(emb, mask, q, 8)
    assert torch.equal(r, pr) and torch.equal(s, ps)
    assert r[:, 3:].tolist() == [[0, 1, 2, 4, 5]] * 2


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    emb = torch.zeros((64, 12), device=cuda)
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        mt.masked_topk(emb, mask, torch.zeros((1, 12), device=cuda), 3)
    emb = torch.zeros((64, 16), device=cuda)
    with pytest.raises(ValueError):
        mt.masked_topk(emb, mask, torch.zeros((1, 16), device=cuda), 65)


def test_a_refused_launch_raises(cuda):
    """The C entry point reports a launch it refuses; the wrapper's check of
    that code is what turns it into an exception."""
    lib = mt._library()
    emb = torch.zeros((64, 16), device=cuda)
    out = torch.empty(16, device=cuda)
    rc = lib.masked_topk(emb.data_ptr(), 0, out.data_ptr(), emb.data_ptr(),
                         64, 16, 1, 3, 5000, out.data_ptr(), out.data_ptr(),
                         out.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    assert rc != 0
