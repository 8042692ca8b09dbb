"""The port's int8 convolution (``ops/int8_conv.py``) and the
``encoder_int8`` depth net against the JAX package's, on the same numpy
inputs, on the CPU (the port's int32 accumulators by its exact int64
version; JAX's by ``lax.conv_general_dilated``).

- the quantisers: bit-equal;
- the output: bit-equal or one ulp of the compute dtype;
- the straight-through gradients: in f32 to 1e-5 of each gradient's
  max-abs; in bf16 each element to one bf16 ulp of its value (2^-7
  relative) plus 2^-8 of the max-abs: both packages compute the same
  bf16 convolution VJP, and the CPU libraries round partial sums to bf16
  in another order (measured: 1.9e-3 of the max-abs at most, in dk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.ops import int8_conv as ti8
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import jax_variables
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.ops import int8_conv as ji8
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import build_model as j_build_model

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

# (name, B, H, W, Cin, Cout, kernel, stride): the encoder's convs, narrowed
CONVS = [
    ("stem", 2, 32, 64, 3, 64, 7, 2),
    ("3x3_s2", 2, 16, 32, 64, 128, 3, 2),
    ("3x3", 2, 16, 32, 64, 64, 3, 1),
    ("1x1_s2", 2, 16, 32, 64, 128, 1, 2),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, h, w, cin, cout, k, s, seed=0):
    rng = np.random.RandomState(seed)
    p = (k - 1) // 2
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(cout, cin, k, k) * 0.1).astype(np.float32)
    g = rng.randn(b, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, cout).astype(np.float32)
    return x, wt, g, p


def _ulps(got, want, dtype):
    """|got - want| in ulps of ``dtype`` at |want|."""
    eps = 2.0**-23 if dtype == "float32" else 2.0**-7
    spacing = np.maximum(np.abs(want), np.finfo(np.float32).tiny) * eps
    return np.abs(got - want) / spacing


def test_quantisers_match_jax():
    x, wt, _, _ = _inputs(2, 16, 32, 64, 128, 3, 1)
    xq, sx = ti8.quant_act(torch.from_numpy(x))
    jxq, jsx = ji8._quant_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert sx.item() == float(jsx)
    wq, sw = ti8.quant_weight(torch.from_numpy(wt))
    jwq, jsw = ji8._quant_kernel(jnp.asarray(wt.transpose(2, 3, 1, 0)))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    assert xq.dtype == wq.dtype == torch.int8 and int(xq.abs().max()) == 127


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("conv", CONVS, ids=[c[0] for c in CONVS])
def test_int8_conv_matches_jax(conv, dtype):
    _, b, h, w, cin, cout, k, s = conv
    tdt, jdt = DTYPES[dtype]
    x, wt, g, p = _inputs(b, h, w, cin, cout, k, s)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    y = ti8.int8_conv(xt, wtt, s, p)
    y.backward(torch.from_numpy(g).to(tdt))
    yj, vjp = jax.vjp(lambda a, kk: ji8.int8_conv(a, kk, (s, s), ((p, p), (p, p))),
                      jnp.asarray(x).astype(jdt), jnp.asarray(wt.transpose(2, 3, 1, 0)))
    dx, dk = vjp(jnp.asarray(g).astype(jdt))
    assert y.dtype == tdt and xt.grad.dtype == tdt and wtt.grad.dtype == torch.float32
    assert np.asarray(dk).dtype == np.float32
    want = np.asarray(yj.astype(jnp.float32))
    assert _ulps(y.detach().float().numpy(), want, dtype).max() <= 1.0
    for got, want in ((xt.grad.float().numpy(), np.asarray(dx.astype(jnp.float32))),
                      (wtt.grad.numpy(), np.asarray(dk).transpose(3, 2, 0, 1))):
        scale = np.abs(want).max()
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-5 * scale
        else:
            assert (np.abs(got - want) <= 2.0**-7 * np.abs(want) + 2.0**-8 * scale).all()


def test_int32_accumulators_are_exact():
    """The plain version's accumulators equal a float64 convolution of the
    int8 operands (every partial sum is an integer below 2^53), at the
    stem's padded K too."""
    for _, b, h, w, cin, cout, k, s in CONVS:
        x, wt, _, p = _inputs(b, h, w, cin, cout, k, s, seed=1)
        xq, _ = ti8.quant_act(torch.from_numpy(x))
        wq, _ = ti8.quant_weight(torch.from_numpy(wt))
        acc = ti8.conv_i32(xq, wq, s, p)
        ref = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(),
                                         stride=s, padding=p).permute(0, 2, 3, 1)
        assert acc.dtype == torch.int32 and torch.equal(acc.double(), ref)


def _jax_depth_net(kw, variables, img):
    """The JAX package's depth net in eval mode: the disparities."""
    jmodel = j_build_model(JConfig(**kw))
    out = jax.jit(lambda v, x: jmodel.apply(v, x, method=lambda m, a: m.depth_net(a, False)))(
        variables, img)
    return [np.asarray(d) for d in out]


def test_encoder_int8_depth_net_matches_jax():
    """The ``encoder_int8`` depth net (the stem, both 3x3 convs of every
    BasicBlock and the 1x1 downsamples in int8) on the port's seed-built
    weights against JAX's ``DepthNet(encoder_int8=True)`` on the same
    weights and image, f32 at 64x128, in eval mode.

    Each conv alone is bit-equal (above), but an activation whose f32 value
    differs by rounding between the packages can round to the next int8
    level, a step of its tensor's scale, and the steps add up layer by
    layer. So the difference is held against the int8 quantisation's own
    effect, JAX's int8 net against JAX's float net on the same weights: at
    every disparity scale the mean difference under a tenth of that gap
    (measured: under 3 %), the largest under 1e-3 (measured: 1.1e-4 at the
    coarsest scale). In train mode the batch statistics pass the flips on
    at the gap's own size (measured: 0.55 of it over the running
    statistics), so that mode is held by the steps that train with the
    option (tests/test_torch_rules.py) and not against JAX."""
    kw = dict(img_hw=(64, 128), batch_size=2, compute_dtype="float32", encoder_int8=True)
    model = build_model(Config(**kw), "cpu")
    assert all(m.int8 for n, m in model.named_modules()
               if n.startswith("depth_net.encoder") and hasattr(m, "int8"))
    # copies: JAX may alias numpy inputs
    params, stats = jax.tree_util.tree_map(np.array, jax_variables(model))
    variables = {"params": params, "batch_stats": stats}
    img = np.random.RandomState(0).rand(2, 64, 128, 3).astype(np.float32)
    want = _jax_depth_net(kw, variables, img)
    ref = _jax_depth_net(dict(kw, encoder_int8=False), variables, img)
    model.depth_net.eval()
    with torch.no_grad():
        got = [d.numpy() for d in model.depth_net(torch.from_numpy(img))]
    assert len(got) == len(want) == 3
    for g, w, r in zip(got, want, ref):
        assert np.abs(g - w).mean() < 0.1 * np.abs(r - w).mean()
        assert np.abs(g - w).max() < 1e-3
