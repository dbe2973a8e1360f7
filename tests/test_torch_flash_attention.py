"""The port's flash attention (``lazzaro_tpu_torch.ops.flash_attention``) on
the CPU, where it runs its plain versions, against the JAX package's Pallas
kernels (forward and backward) in interpret mode and its einsum reference,
on the same numpy inputs.

Tolerances are the JAX package's own (``tests/test_flash_attention.py``):
atol/rtol 2e-5 in f32 for the forward against its reference, 2e-4 for the
backward's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.ops import flash_attention as jfa
from lazzaro_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("B,T,S,H,Hkv,D", [
    (2, 64, 64, 4, 2, 32),     # GQA, block-aligned
    (1, 37, 37, 4, 4, 16),     # MHA, odd length (JAX pads internally)
    (1, 8, 8, 2, 1, 8),        # tiny, extreme GQA
    (1, 13, 29, 2, 2, 16),     # S > T: end-aligned chunked prefill
    (1, 8, 24, 4, 1, 8),       # S > T with MQA
    (1, 16, 16, 2, 1, 192),    # head_dim 192 (the kernel's third width)
    (1, 40, 107, 4, 2, 16),    # S - T = 67, a multiple of no block
])
def test_flash_matches_jax_kernel_and_lse(B, T, S, H, Hkv, D):
    q, k, v = (_rand((B, T, H, D), 0), _rand((B, S, Hkv, D), 1),
               _rand((B, S, Hkv, D), 2))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = jfa.flash_attention(jq, jk, jv, blk_q=8, blk_k=8, interpret=True)
    _, _, want_lse = jfa._forward_with_residuals(jq, jk, jv, 8, 8, True)
    got = fa.flash_attention(tq, tk, tv)
    out, lse = fa.flash_attention_fwd(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(out, got)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., :T, 0],
                               **TOL)


def test_reference_gqa_matches_jax():
    q, k, v = _rand((2, 19, 4, 16), 3), _rand((2, 19, 2, 16), 4), _rand((2, 19, 2, 16), 5)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    np.testing.assert_allclose(fa.reference_gqa(tq, tk, tv).numpy(),
                               np.asarray(jfa._reference_gqa(jq, jk, jv)), **TOL)


@pytest.mark.parametrize("scale,softcap", [(0.0, 0.0), (0.3, 0.0), (0.0, 5.0),
                                           (0.25, 2.0)])
def test_reference_attention_matches_jax(scale, softcap):
    """The decoder's materialized-scores path, with Gemma-2's query scale
    and softcap and an arbitrary mask (rows with every key masked too)."""
    q, k, v = _rand((2, 11, 4, 16), 6), _rand((2, 17, 2, 16), 7), _rand((2, 17, 2, 16), 8)
    mask = np.random.RandomState(9).rand(2, 11, 17) < 0.6
    mask[0, 3] = False
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    want = jfa.reference_attention(jq, jk, jv, jm, scale=scale, softcap=softcap)
    got = fa.reference_attention(tq, tk, tv, tm, scale=scale, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_attention_rounds_like_jax_in_bf16():
    """bf16: scores from a bf16 product cast to f32, P cast to bf16 before
    the P.V product, as in JAX (one bf16 step of slack for the two
    frameworks' own product rounding)."""
    q, k, v = _rand((1, 9, 2, 16), 10), _rand((1, 9, 2, 16), 11), _rand((1, 9, 2, 16), 12)
    mask = np.tril(np.ones((9, 9), bool))[None]
    want = jfa.reference_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                   jnp.asarray(mask))
    got = fa.reference_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                 torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=1.6e-2)


def test_plain_flash_equals_reference_path():
    q, k, v = _rand((2, 40, 8, 32), 13), _rand((2, 40, 2, 32), 14), _rand((2, 40, 2, 32), 15)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(fa.flash_attention(tq, tk, tv).numpy(),
                               fa.reference_gqa(tq, tk, tv).numpy(), **TOL)


def test_kv_shorter_than_q_rejected():
    q, k = torch.from_numpy(_rand((1, 16, 2, 8), 13)), torch.from_numpy(_rand((1, 8, 2, 8), 14))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, k)


def test_causality():
    """Perturbing a future key or value must not change earlier outputs."""
    q, k, v = (torch.from_numpy(_rand((1, 32, 2, 16), s)) for s in (3, 4, 5))
    base = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] += 3.0
    v2[:, 20:] -= 2.0
    pert = fa.flash_attention(q, k2, v2)
    np.testing.assert_allclose(base[:, :20].numpy(), pert[:, :20].numpy(), atol=1e-6)
    assert not np.allclose(base[:, 20:].numpy(), pert[:, 20:].numpy())


@pytest.mark.parametrize("B,T,S,H,Hkv,D", [
    (2, 16, 16, 4, 2, 8),      # GQA rep=2, self-attention
    (1, 8, 24, 4, 1, 8),       # S > T with MQA (rep=4)
    (1, 13, 21, 2, 2, 8),      # ragged T and S (JAX pads internally)
    (1, 37, 37, 4, 2, 16),     # odd T
    (1, 16, 16, 2, 1, 192),    # head_dim 192 (a width the kernels template on)
    (1, 13, 40, 4, 2, 64),     # ragged S > T (S - T = 27) at head_dim 64
])
def test_flash_gradients_match_jax_pallas_backward(B, T, S, H, Hkv, D):
    """The port's autograd backward (plain on the CPU) against ``jax.vjp``
    of the JAX ``flash_attention``, whose Pallas dQ and dK/dV kernels run in
    interpret mode, with a non-trivial upstream gradient. atol/rtol 2e-4,
    the JAX test's own for its backward."""
    q, k, v = (_rand((B, T, H, D), 1), _rand((B, S, Hkv, D), 2),
               _rand((B, S, Hkv, D), 3))
    g = _rand((B, T, H, D), 4)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both(q, k, v, g)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, blk_q=8, blk_k=8, interpret=True), jq, jk, jv)
    want = vjp(jg)
    leaves = [x.requires_grad_(True) for x in (tq, tk, tv)]
    fa.flash_attention(*leaves).backward(tg)
    for name, got, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=2e-4, rtol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("B,T,S,H,Hkv,D", [
    (2, 19, 19, 4, 2, 16),
    (1, 5, 30, 8, 1, 8),
])
def test_bwd_reference_matches_autograd_of_reference_gqa(B, T, S, H, Hkv, D):
    """The kernels' plain arithmetic (scores recomputed from the LSE, delta
    = rowsum(dO * O)) against autograd through the materialized-scores
    reference, in f32."""
    q, k, v = (torch.from_numpy(_rand(s, i)) for i, s in enumerate(
        ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D)), start=20))
    do = torch.from_numpy(_rand((B, T, H, D), 23))
    out, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.reference_gqa(*leaves).backward(do)
    for name, g, leaf in zip("qkv", got, leaves):
        assert g.shape == leaf.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name}")


def test_bwd_reference_rounds_dS_and_P_to_the_input_type():
    """bf16: the plain backward casts P and dS to bf16 before the products
    and returns bf16 gradients; it stays within a few bf16 steps of the f32
    computation on the same (bf16-exact) inputs."""
    q, k, v, do = (torch.from_numpy(_rand(s, i)).bfloat16() for i, s in enumerate(
        ((1, 12, 4, 16), (1, 12, 2, 16), (1, 12, 2, 16), (1, 12, 4, 16)), start=30))
    out, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    want = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                            out.float(), lse, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= 3e-2 * scale


def test_bwd_wrapper_takes_only_cpu_and_cuda_tensors():
    x = torch.zeros((1, 8, 2, 8), device="meta")
    lse = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(x, x, x, x, lse, x)


def test_no_backward_kernel_launch_on_the_cpu():
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    q = torch.from_numpy(_rand((1, 8, 2, 8), 1)).requires_grad_(True)
    fa.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == before


def test_wrapper_takes_only_cpu_and_cuda_tensors():
    x = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(x, x, x)


def test_no_kernel_launch_on_the_cpu():
    before = fa.launches
    q = torch.from_numpy(_rand((1, 8, 2, 8), 1))
    fa.flash_attention(q, q, q)
    assert fa.launches == before
