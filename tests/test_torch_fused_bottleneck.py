"""The fused identity bottleneck (K3) of the port against the JAX package on
the CPU: the BatchNorm fold, the plain version against the Pallas kernel in
interpret mode, and the fused ResNet path.

Tolerances: folded weights within one bf16 ulp (the float32 products may
round to the neighbouring bf16 in another order), biases within 1e-6; the
plain K3 against `fused_bottleneck_stack(..., interpret=True)` within the
JAX test's 5e-2 (8e-2 for a chain of two blocks): both round y1 and y2 to
bf16 but sum in another order, so a value may land one bf16 step apart; the
fused r50 stage outputs within 1e-1 of each stage's scale, the JAX test's
bound for fused against unfused, since the projection blocks run bf16
convs in two frameworks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgv3d_tpu.nn.resnet import ResNet as JResNet
from sgv3d_tpu.ops.pallas_bottleneck import (
    fold_bottleneck_params, fused_bottleneck_stack)
from sgv3d_tpu_torch.api import BEVHeightPredictor
from sgv3d_tpu_torch.models.bev_height import BEVHeight
from sgv3d_tpu_torch.nn.resnet import Bottleneck, ResNet
from sgv3d_tpu_torch.ops.fused_bottleneck import (
    KERNEL_P, SMEM_LIMIT, FoldedBottleneck, fold_bottleneck, fused_bottleneck,
    fused_bottleneck_plain, pack_weight, ring_stages, ring_tile, smem_bytes,
    tile_shape, unpack_weight)
from sgv3d_tpu_torch.tools import k3_probe
from sgv3d_tpu_torch.weights import from_flax
from tests.test_pallas_bottleneck import _make_block
from tests.test_torch_modules import _shapes
from tests.tiny_configs import tiny_exp
from tests.torch_port_util import randomize_flax, to_port


def _port_block(variables, planes, c):
    block = Bottleneck(c, planes)
    block.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)),
                          strict=True)
    return block.eval()


def _as_jax_layout(fb: FoldedBottleneck) -> dict:
    """The port's kernel layout -> `fold_bottleneck_params`' layout."""
    p, c = fb.w1.shape
    f = lambda t: unpack_weight(t, p).float().numpy()   # noqa: E731
    return {"w1": f(fb.w1).T,
            "w2": f(fb.w2).reshape(p, 9, p).transpose(1, 2, 0),
            "w3": f(fb.w3).T,
            "b1": fb.b1.numpy()[None], "b2": fb.b2.numpy()[None],
            "b3": fb.b3.numpy()[None]}


def test_fold_matches_jax():
    rng = np.random.default_rng(0)
    planes, c = 8, 32
    _, variables = _make_block(rng, planes, c)
    ref = fold_bottleneck_params(variables["params"], variables["batch_stats"])
    got = _as_jax_layout(fold_bottleneck(_port_block(variables, planes, c)))
    for name in ("w1", "w2", "w3"):
        r = np.asarray(ref[name], np.float32)
        assert got[name].shape == r.shape
        ulp = np.abs(r) * 2.0 ** -7          # one bf16 step at the value
        assert np.all(np.abs(got[name] - r) <= ulp + 1e-30), name
    for name in ("b1", "b2", "b3"):
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("h,w", [(12, 16), (9, 8)])
def test_plain_matches_pallas(h, w):
    """Large positive BN biases: a y1 that leaked relu(b1) through conv2's
    zero padding would fail by far more than the tolerance."""
    rng = np.random.default_rng(0)
    planes, c = 8, 32
    _, variables = _make_block(rng, planes, c)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    fw = fold_bottleneck_params(variables["params"], variables["batch_stats"])
    want = np.asarray(fused_bottleneck_stack(jnp.asarray(x), [fw],
                                             interpret=True), np.float32)
    fb = fold_bottleneck(_port_block(variables, planes, c))
    got = fused_bottleneck(torch.from_numpy(x).to(torch.bfloat16), fb)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=5e-2)


def test_plain_chain_matches_pallas():
    rng = np.random.default_rng(1)
    planes, c = 8, 32
    (_, v1), (_, v2) = _make_block(rng, planes, c), _make_block(rng, planes, c)
    x = rng.standard_normal((1, 12, 8, c)).astype(np.float32)
    fws = [fold_bottleneck_params(v["params"], v["batch_stats"]) for v in (v1, v2)]
    want = np.asarray(fused_bottleneck_stack(jnp.asarray(x), fws,
                                             interpret=True), np.float32)
    got = torch.from_numpy(x).to(torch.bfloat16)
    for v in (v1, v2):
        got = fused_bottleneck(got, fold_bottleneck(_port_block(v, planes, c)))
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-2, rtol=8e-2)


@pytest.mark.parametrize("h", [6, 13])
def test_plain_conv2_padding_is_zero_in_y1_space(h):
    """w1 = 0, b1 = 1, w2 = w3 = 1: the output counts conv2's taps inside
    the image (9 inside, 6 on an edge, 4 in a corner), exactly."""
    p, c, w = 8, 32, 8
    fb = FoldedBottleneck(
        w1=torch.zeros(p, c, dtype=torch.bfloat16), b1=torch.ones(p),
        w2=torch.ones(p, 9 * p, dtype=torch.bfloat16), b2=torch.zeros(p),
        w3=torch.ones(c, p, dtype=torch.bfloat16), b3=torch.zeros(c))
    out = fused_bottleneck_plain(torch.zeros(1, h, w, c, dtype=torch.bfloat16), fb)
    taps = np.full((h, w), 9.0)
    taps[[0, -1], :] = 6.0
    taps[:, [0, -1]] = 6.0
    taps[np.ix_([0, -1], [0, -1])] = 4.0
    np.testing.assert_array_equal(out[0].float().numpy(),
                                  np.broadcast_to((taps * p * p)[..., None],
                                                  (h, w, c)))


def test_fused_resnet_matches_jax_fused():
    """A narrow r50 with fused=True under CPU bf16 autocast against flax
    ResNet(50, fused=True, dtype=bfloat16) on the same weights."""
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
    kwargs = dict(depth=50, base_channels=8, dtype=jnp.bfloat16)
    variables = randomize_flax(_shapes(JResNet(**kwargs), x, False), seed=2)
    want = jax.jit(JResNet(fused=True, **kwargs).apply, static_argnums=2)(
        variables, jnp.asarray(x), False)
    port = ResNet(50, base_channels=8, fused=True)
    port.load_state_dict(from_flax(variables), strict=True)
    port.eval()
    with pytest.raises(RuntimeError, match="fold"):
        port(torch.from_numpy(x).permute(0, 3, 1, 2))
    port.fold()
    assert sorted(port._folded) == [f"layer{s + 1}_block{b}"
                                    for s, n in enumerate((3, 4, 6, 3))
                                    for b in range(1, n)]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for g, wv in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().permute(0, 2, 3, 1).numpy()
        wv = np.asarray(wv, np.float32)
        assert g.shape == wv.shape
        np.testing.assert_allclose(g, wv, rtol=0, atol=1e-1 * np.abs(wv).max())


def _r50_exp():
    cfg = to_port(tiny_exp(is_bsm=True))
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, resnet_depth=50))


def test_state_dict_keys_do_not_depend_on_fused_convs():
    cfg = _r50_exp()
    fused = BEVHeight(cfg, use_bf16=True, fused_convs=True)
    keys = list(BEVHeight(cfg, use_bf16=True).state_dict())
    assert list(fused.state_dict()) == keys
    fused.backbone.img_backbone.fold()
    assert list(fused.state_dict()) == keys


def test_fused_convs_raises_where_it_cannot_be_honoured():
    r50, r18 = _r50_exp(), to_port(tiny_exp(is_bsm=True))
    with pytest.raises(ValueError, match="fused_convs"):
        BEVHeightPredictor(r50, {}, device="cpu", fused_convs=True)  # no bf16
    with pytest.raises(ValueError, match="fused_convs"):
        BEVHeightPredictor(r50, {}, device="cuda", use_bf16=False,
                           fused_convs=True)
    with pytest.raises(ValueError, match="fused_convs"):
        BEVHeightPredictor(r18, {}, device="cuda", fused_convs=True)
    with pytest.raises(ValueError, match="depth >= 50"):
        ResNet(18, fused=True)
    with pytest.raises(ValueError, match="projection"):
        fold_bottleneck(Bottleneck(16, 8))


@pytest.mark.parametrize("p", KERNEL_P)
def test_kernel_plan_fits(p):
    """The tile of every r50/r101 width: output pixels a multiple of 64
    (wgmma's m64 row blocks), rows of 8 pixels (phase 2's ldmatrix rows),
    the block's shared memory within sm_90's limit, whole ring stages."""
    th, tw = tile_shape(p)
    nb, kc = ring_tile(p)
    assert (th * tw) % 64 == 0 and tw % 8 == 0
    assert smem_bytes(p) <= SMEM_LIMIT
    assert p % nb == 0 and p % kc == 0 and kc == 64
    for th, tw, stages in k3_probe.ALTERNATIVES[p]:
        assert smem_bytes(p, (th, tw), stages) <= SMEM_LIMIT


@pytest.mark.parametrize("p", KERNEL_P)
def test_probe_rewrites_the_kernel_source(p):
    """The probe's copies of the kernel: its phase stamps find their
    anchors in the source and its launch at width P takes the variant's
    tile and ring depth."""
    src = k3_probe._variant_source(p, (8, 8), 5)
    assert src.count("stamp()") == 6 and "k3_stamps" in src
    th, tw = tile_shape(p)
    assert f"launch<Cfg<{p}, 8, 8, 5>>" in src
    assert f"launch<Cfg<{p}, {th}, {tw}, {ring_stages(p)}>>" not in src


@pytest.mark.parametrize("p", (8,) + KERNEL_P)
def test_packed_weights_unpack_exactly(p):
    """pack_weight only moves elements: unpacking gives back the (P, C),
    (P, 9P) and (C, P) matrices bit for bit, and a stage's tile is the
    matrix block it claims, 16-byte groups swizzled by row."""
    gen = torch.Generator().manual_seed(p)
    c = 4 * p
    for n, k in ((p, c), (p, 9 * p), (c, p)):
        w = torch.randn(n, k, generator=gen).to(torch.bfloat16)
        packed = pack_weight(w, p)
        assert packed.shape == w.shape and packed.is_contiguous()
        assert torch.equal(unpack_weight(packed, p), w)
        nb, kc = ring_tile(p)
        g = kc // 8
        stage = packed.reshape(-1)[nb * kc:2 * nb * kc].reshape(nb, g, 8)
        block = w[:nb, kc:2 * kc].reshape(nb, g, 8) if k > kc else \
            w[nb:2 * nb, :kc].reshape(nb, g, 8)
        for row in (0, nb - 1):
            for j in range(g):
                assert torch.equal(stage[row, j], block[row, j ^ (row % g)])
