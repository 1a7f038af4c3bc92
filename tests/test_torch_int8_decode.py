"""The dense int8 decode attention's wrapper on the CPU: the plain version
over the caches' first n rows, and why the kernel may read only the rows
up to the position (the kernel itself is held to the plain version on the
card, tests/test_torch_cuda_kernels.py)."""

import pytest
import torch

from yourmt3_tpu_torch.models.layers import NEG_INF
from yourmt3_tpu_torch.ops.kv_quant import (int8_decode_attention,
                                            int8_decode_attention_plain, quantize_kv)

S, H, L, DK = 3, 2, 64, 32


def _caches(gen):
    kq, ks = quantize_kv(torch.randn(S, H, L, DK, generator=gen))
    vq, vs = quantize_kv(torch.randn(S, H, L, DK, generator=gen))
    return kq, ks, vq, vs


def _causal_bias(gen, M, n, pos):
    """A decoder step's bias row: a random relative bias, -1e9 past pos."""
    j = torch.arange(n)
    mask = torch.where(j > pos, NEG_INF, 0.0)
    return torch.randn(1, H, M, n, generator=gen) + mask


def _weight_ulp_bound(vq, vs):
    """How far two fp32 routings of one function may part: the plain
    version rounds each softmax weight w_j · vs_j to bf16, so a weight
    summed in another order may round one bf16 ulp (2^-7 of it) apart, and
    the weights sum to one: 2^-7 · max |v · vs|."""
    return 2.0 ** -7 * (vq.float() * vs[..., None]).abs().max().item()


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("n,pos", [(L, None), (L, 17), (40, 39), (40, 0)])
@pytest.mark.parametrize("position", ["int", "tensor"])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
def test_cpu_wrapper_is_the_plain_version_over_n_rows(M, n, pos, position, qdt):
    """CPU tensors: the plain version over rows [0, n), bit for bit, with
    no launch counted, whatever the position's form."""
    gen = torch.Generator().manual_seed(n + M)
    kq, ks, vq, vs = _caches(gen)
    q = torch.randn(S, H, M, DK, generator=gen).to(qdt)
    bias = _causal_bias(gen, M, n, n if pos is None else pos)
    if pos is not None and position == "tensor":
        pos = torch.tensor(pos)
    before = int8_decode_attention.launches
    got = int8_decode_attention(q, kq, ks, vq, vs, bias, n=n, pos=pos)
    want = int8_decode_attention_plain(q, kq[:, :, :n], ks[:, :, :n], vq[:, :, :n],
                                       vs[:, :, :n], bias)
    assert got.dtype == qdt and got.shape == (S, H, M, DK)
    assert torch.equal(got, want)
    assert int8_decode_attention.launches == before
    # no horizon: every row, the cross call's form
    full = int8_decode_attention(q, kq, ks, vq, vs)
    assert torch.equal(full, int8_decode_attention_plain(q, kq, ks, vq, vs, None))


@pytest.mark.parametrize("n,pos", [(L, 0), (L, 5), (L, 31), (L, L - 1), (48, 0), (48, 5),
                                   (48, 31), (48, 47)])
def test_rows_past_the_position_add_nothing(n, pos):
    """The plain version over all n rows with the causal bias row equals it
    over rows [0, pos] alone (the bias's -1e9 gives exp(x) = 0 exactly in
    fp32), so the kernel, which reads only rows [0, min(pos + 1, n)), is
    the same function."""
    gen = torch.Generator().manual_seed(100 + pos)
    kq, ks, vq, vs = _caches(gen)
    q = torch.randn(S, H, 1, DK, generator=gen)
    bias = _causal_bias(gen, 1, n, pos)
    live = pos + 1
    full = int8_decode_attention(q, kq, ks, vq, vs, bias, n=n, pos=torch.tensor(pos))
    cut = int8_decode_attention_plain(q, kq[:, :, :live], ks[:, :, :live],
                                      vq[:, :, :live], vs[:, :, :live],
                                      bias[..., :live])
    torch.testing.assert_close(full, cut, rtol=0, atol=_weight_ulp_bound(vq, vs))
    # the rows past pos do move the output once the bias stops masking them
    # (the check above is not empty)
    if pos < n - 1:
        open_bias = bias.clone()
        open_bias[..., live:] = 0.0
        opened = int8_decode_attention_plain(q, kq[:, :, :n], ks[:, :, :n],
                                             vq[:, :, :n], vs[:, :, :n], open_bias)
        assert (opened - cut).abs().max().item() > _weight_ulp_bound(vq, vs)


def test_a_position_needs_the_bias_that_masks_past_it():
    gen = torch.Generator().manual_seed(3)
    kq, ks, vq, vs = _caches(gen)
    q = torch.randn(S, H, 1, DK, generator=gen)
    with pytest.raises(ValueError, match="bias"):
        int8_decode_attention(q, kq, ks, vq, vs, None, pos=3)

