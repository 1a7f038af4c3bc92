"""The int8-weight product (`ops/weight_quant.py` `int8_linear`).

On the CPU the wrapper is the plain version, the five operations the
int8 `QuantDense` ran before it had a kernel, bit for bit. The cases
marked `cuda` hold the kernel (`ops/csrc/int8_linear.cu`) to the plain
version on the card and skip without one. The file imports nothing of
JAX, so on a machine without it run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_int8_linear.py
"""

import pytest
import torch
import torch.nn.functional as F

from yourmt3_tpu_torch.models.layers import QuantDense
from yourmt3_tpu_torch.ops.weight_quant import (int8_linear, int8_linear_plain,
                                                quantize_int8)

# decode rows: 7 and 8 segments of 13 channels, greedy and beam 2
ROWS = [1, 91, 104, 208]
# (K, N): self q/k/v, o, wi_0/wi_1, wo, the LM head (ragged N), a GQA k/v
SHAPES = [(512, 384), (384, 512), (512, 1024), (1024, 512), (512, 597), (512, 128)]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
CROSS_ROWS = 26624  # the cross projection: 8 segments x 13 channels x 256 frames


def _case(M, K, N, dtype, seed, device="cpu", row_stride=None):
    """x (M, K) N(0, 1) in `dtype`, rows `row_stride` apart when given, and an
    int8 weight quantized from N(0, 1/K) with its fp32 scales."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(M, row_stride or K, generator=gen).to(device, dtype)[:, :K]
    w_q, scale = quantize_int8(torch.randn(N, K, generator=gen) / K ** 0.5)
    return x, w_q.to(device), scale.to(device)


def _five_ops(x, w_q, scale, dtype):
    """The int8 branch of QuantDense.forward as it was: the weight cast,
    the product, the cast to fp32, the scale, the cast back."""
    y = F.linear(x.to(dtype), w_q.to(dtype))
    return (y.to(torch.float32) * scale).to(dtype)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("M", ROWS)
def test_cpu_wrapper_is_the_five_operations(M, K, N, dt):
    """CPU tensors: the wrapper is the plain version, which is the five
    operations QuantDense ran, bit for bit, and counts no launch."""
    x, w_q, scale = _case(M, K, N, DTYPES[dt], seed=M + K + N)
    before = int8_linear.launches
    got = int8_linear(x, w_q, scale)
    assert got.dtype == DTYPES[dt] and got.shape == (M, N)
    assert torch.equal(got, int8_linear_plain(x, w_q, scale))
    assert torch.equal(got, _five_ops(x, w_q, scale, DTYPES[dt]))
    assert int8_linear.launches == before


@pytest.mark.parametrize("dt", DTYPES)
def test_cpu_row_strided_x(dt):
    """x with rows wider apart than K (a view of a wider tensor) is taken
    as it is: the five operations on the same view."""
    x, w_q, scale = _case(104, 512, 384, DTYPES[dt], seed=5, row_stride=512 + 64)
    assert x.stride() == (576, 1)
    assert torch.equal(int8_linear(x, w_q, scale), _five_ops(x, w_q, scale, DTYPES[dt]))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lead", [(104, 1), (13, 7), (2, 3, 5)],
                         ids=["step", "sequence", "rank4"])
def test_quantdense_int8_forward_unchanged(lead, dt):
    """QuantDense's int8 branch, now one call on x flattened to (M, K),
    gives the output it gave before on the CPU, for a decode step's rows,
    a sequence and a rank-4 input, and for the attention's merged heads at
    one position (a view of the (S, H, 1, dk) output)."""
    K, N = 384, 512
    lin = QuantDense(K, N, DTYPES[dt])
    with torch.no_grad():
        lin.weight.copy_(torch.randn(N, K, generator=torch.Generator().manual_seed(1)) / 20)
    lin.set_weight_quant("int8")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(*lead, K, generator=gen)
    got = lin(x)
    assert got.shape == (*lead, N) and got.dtype == DTYPES[dt]
    assert torch.equal(got, _five_ops(x, lin.weight_q, lin.weight_scale, DTYPES[dt]))
    att = torch.randn(104, 6, 1, 64, generator=gen).to(DTYPES[dt])
    merged = att.transpose(1, 2).reshape(104, 1, 384)
    assert torch.equal(lin(merged),
                       _five_ops(merged, lin.weight_q, lin.weight_scale, DTYPES[dt]))


@pytest.mark.parametrize("mode", ["none", "bf16"])
def test_quantdense_other_branches_unchanged(mode):
    """The fp32-master and bf16 side-car branches still cast and multiply
    as they did."""
    lin = QuantDense(64, 48, torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(48, 64, generator=torch.Generator().manual_seed(3)))
    lin.set_weight_quant(mode)
    x = torch.randn(5, 2, 64, generator=torch.Generator().manual_seed(4))
    w = lin.weight if mode == "none" else lin.weight_q
    assert torch.equal(lin(x), F.linear(x.to(torch.bfloat16), w.to(torch.bfloat16)))


def _bad_args():
    x, w_q, scale = _case(4, 32, 16, torch.bfloat16, seed=6)
    return {
        "x_fp16": ((x.half(), w_q, scale), TypeError),
        "w_not_int8": ((x, w_q.to(torch.bfloat16), scale), TypeError),
        "w_uint8": ((x, w_q.to(torch.uint8), scale), TypeError),
        "scale_bf16": ((x, w_q, scale.to(torch.bfloat16)), TypeError),
        "x_rank3": ((x[None], w_q, scale), ValueError),
        "k_mismatch": ((x[:, :16], w_q, scale), ValueError),
        "scale_length": ((x, w_q, scale[:-1]), ValueError),
        "w_rank1": ((x, w_q[0], scale), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
def test_wrapper_raises_on_wrong_dtype_or_shape(case):
    args, error = _bad_args()[case]
    with pytest.raises(error):
        int8_linear(*args)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    a = v.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_kernel(x, w_q, scale):
    """The kernel against the plain version on the same card, per element.

    Both take the sum in fp32, in other orders, which may part by a few
    fp32 roundings of the sum of |x w| (more than a bf16 ulp of the result
    where the terms cancel): `order` = 2^-16 of that sum. bf16: both round
    the sum to bf16, so the pre-scale products may part by one bf16 ulp
    of the product's rounding plus `order`; with unit scales the output is
    that product and is held to exactly that; with the scales, that times
    the scale plus the rounding of each side's scaled value (2 ulps of the
    output). fp32: `order` times the scale."""
    got = int8_linear(x, w_q, scale)
    want = int8_linear_plain(x, w_q, scale)
    assert got.dtype == x.dtype and got.shape == want.shape and got.is_contiguous()
    err = (got.double() - want.double()).abs()
    order = 2.0 ** -16 * (x.double().abs() @ w_q.double().abs().T)
    if x.dtype == torch.bfloat16:
        pre = F.linear(x, w_q.to(x.dtype))
        unit = int8_linear(x, w_q, torch.ones_like(scale))
        assert bool(((unit.double() - pre.double()).abs() <= _bf16_ulp(pre) + order).all())
        tol = (_bf16_ulp(pre) + order) * scale.double() + 2 * _bf16_ulp(want)
    else:
        tol = order * scale.double()
    assert bool((err <= tol).all()), (err - tol).max().item()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("M", ROWS)
def test_kernel_matches_plain(dev, M, K, N, dt):
    before = int8_linear.launches
    check_kernel(*_case(M, K, N, DTYPES[dt], seed=M * K + N, device=dev))
    torch.cuda.synchronize()
    # the checked call, and for bf16 the call with unit scales
    assert int8_linear.launches == before + (2 if dt == "bf16" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_kernel_row_strided_x(dev, dt):
    """x with rows 576 elements apart reads in place, equal to its
    contiguous copy bit for bit."""
    x, w_q, scale = _case(104, 512, 384, DTYPES[dt], seed=7, device=dev, row_stride=576)
    assert x.stride() == (576, 1)
    got = check_kernel(x, w_q, scale)
    assert torch.equal(got, int8_linear(x.contiguous(), w_q, scale))


@pytest.mark.cuda
def test_kernel_cross_projection_rows(dev):
    """The cross projection's 26,624 rows (once a batch), bf16."""
    check_kernel(*_case(CROSS_ROWS, 512, 384, torch.bfloat16, seed=8, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_kernel_is_deterministic(dev, dt):
    """A fixed order of sums: two runs agree bit for bit."""
    x, w_q, scale = _case(208, 1024, 512, DTYPES[dt], seed=9, device=dev)
    assert torch.equal(int8_linear(x, w_q, scale), int8_linear(x, w_q, scale))


@pytest.mark.cuda
def test_one_kernel_per_call(dev):
    """One call runs one kernel, int8_linear_kernel, and nothing else: no
    weight cast, no library GEMM, no fp32 scale."""
    from torch.profiler import ProfilerActivity, profile
    x, w_q, scale = _case(104, 512, 1024, torch.bfloat16, seed=10, device=dev)
    int8_linear(x, w_q, scale)  # loads the operator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int8_linear(x, w_q, scale)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "int8_linear_kernel" in names[0], names


@pytest.mark.cuda
def test_graph_replay_equals_eager(dev):
    """Captured in a CUDA graph (the output allocated from the graph's
    pool) and replayed on new inputs: the eager call's output."""
    x, w_q, scale = _case(208, 512, 597, torch.bfloat16, seed=11, device=dev)
    static_x = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        int8_linear(static_x, w_q, scale)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_linear(static_x, w_q, scale)
    for seed in (12, 13):
        fresh = _case(208, 512, 597, torch.bfloat16, seed=seed, device=dev)[0]
        static_x.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, int8_linear(fresh, w_q, scale))
