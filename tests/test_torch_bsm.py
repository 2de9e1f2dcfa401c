"""The SGV3D (BSM) slice of the port against the JAX package on the CPU,
float32, the same randomised weights through `weights.from_flax`.

Tolerances: `resize_bilinear` within 1e-6 (the same arithmetic); modules
within 1e-4 of each output's scale (float32 convs sum in another order);
the tiny predictor's heads within 1e-3 of scale and boxes equal as a
tie-aware set, every untied box within 1e-3 relative (as
tests/test_torch_slice.py). The background-suppression keep mask is a hard
cut at P(background) = 0.45: the masks must be equal, a flip being allowed
only where |P - 0.45| < 1e-5, and the seeded inputs are asserted to have
no pixel that close, so they must match exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sgv3d_tpu.api import BEVHeightPredictor as JaxPredictor
from sgv3d_tpu.data.synthetic import make_batch
from sgv3d_tpu.models.bev_height import BEVHeight as JaxBEVHeight
from sgv3d_tpu.nn import blocks as jblocks
from sgv3d_tpu.nn.lss_fpn import BSMLSSFPN as JBSMLSSFPN
from sgv3d_tpu.nn.msct_head import MSCThead as JMSCThead
from sgv3d_tpu.ops.resize import resize_bilinear as jresize
from sgv3d_tpu_torch.api import BEVHeightPredictor
from sgv3d_tpu_torch.nn import blocks
from sgv3d_tpu_torch.nn.lss_fpn import BSMLSSFPN
from sgv3d_tpu_torch.nn.msct_head import MSCThead
from sgv3d_tpu_torch.ops.resize import resize_bilinear
from sgv3d_tpu_torch.weights import from_flax
from tests.test_torch_modules import _close, _np, _nhwc, _run, _shapes, _t
from tests.tiny_configs import tiny_exp
from tests.torch_port_util import as_plain, randomize_flax, to_port

BG_THRESHOLD = 0.45
FLIP_BAND = 1e-5


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape,kw", [
    ((2, 5, 7, 3), {"scale": 2}),          # TaskFPN's x2, edge rows included
    ((1, 6, 4, 2), {"size": (9, 11)}),     # a non-integer ratio
    ((6, 4, 2), {"size": (3, 3)}),         # HWC, downsampling
])
def test_resize_bilinear(rng, shape, kw, align_corners):
    x = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(x), align_corners=align_corners, **kw))
    got = resize_bilinear(torch.from_numpy(x), align_corners=align_corners,
                          **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_resize_x2_is_torch_half_pixel_bilinear(rng):
    """jax.image.resize's x2 bilinear is F.interpolate(align_corners=False),
    edge rows and columns included (clamped, not zero-weighted)."""
    x = rng.normal(size=(2, 4, 6, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 8, 12, 3), "bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], rtol=0, atol=1e-6)


def test_sablock(rng):
    x = _nhwc(rng, 2, 6, 8, 5)
    y = _nhwc(rng, 2, 6, 8, 7)
    _run(jblocks.SABlock(9), blocks.SABlock(5, 7, 9), (x, y), (_t(x), _t(y)))


@pytest.mark.parametrize("return_feat", [True, False])
def test_task_head(rng, return_feat):
    x = _nhwc(rng, 2, 6, 8, 12)
    _run(jblocks.TaskHead(16, 5), blocks.TaskHead(12, 16, 5),
         (x, False, return_feat), (_t(x),),
         call=lambda m, a: m(a, return_feat=return_feat))


def test_task_fpn(rng):
    coarse = _nhwc(rng, 2, 3, 5, 12)
    fine = _nhwc(rng, 2, 6, 10, 8)
    _run(jblocks.TaskFPN(8), blocks.TaskFPN(12, 8, 8), (coarse, fine),
         (_t(coarse), _t(fine)))


def test_msct_head(rng):
    f16 = _nhwc(rng, 2, 4, 6, 24)
    f8 = _nhwc(rng, 2, 8, 12, 24)
    mlp = (rng.normal(size=(2, 27)) * 3).astype(np.float32)
    jmod = JMSCThead((32, 16), depth_channels=8, semantic_channels=4,
                     context_channels=16)
    port = MSCThead(24, 24, (32, 16), 8, 4, 16)
    _run(jmod, port, ([f16, f8], mlp, False),
         (_t(f16), _t(f8), torch.from_numpy(mlp)),
         call=lambda m, a, b, c: m(a, b, c))
    # depth_head0 is an identity: no module, no weights
    assert not any("depth_head0" in k for k in port.state_dict())


def test_mlp_is_float32_under_autocast(rng):
    """The flax Mlp has no dtype, so its Dense layers run float32 inside a
    bf16 backbone; the port's Mlp leaves the autocast region."""
    mlp = blocks.Mlp(27, 16, 12)
    x = torch.from_numpy(_nhwc(rng, 4, 27))
    with torch.no_grad():
        ref = mlp(x)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = mlp(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------


def _bsm_cfg(top_k):
    """The tiny BSM exp with the serving knobs of chip_smoke's tiny phase."""
    cfg = tiny_exp(is_bsm=True)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, lift_top_k=top_k,
        x_bound=(0.0, 12.8, 1.6), y_bound=(-6.4, 6.4, 1.6)))
    assert as_plain(to_port(cfg)) == as_plain(
        chip_smoke.tiny_serving_exp(top_k, is_bsm=True))
    return cfg


def _variables(cfg, imgs, mats, seed):
    shapes = jax.eval_shape(
        lambda x, m: JaxBEVHeight(cfg).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            x, m, False),
        jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in mats.items()})
    return randomize_flax(shapes, seed)


def _p_background(semantic1, nhwc):
    s = np.asarray(semantic1, np.float64)
    s = s if nhwc else s.transpose(0, 2, 3, 1)
    e = np.exp(s - s.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[..., 0]


def _assert_keep_masks_match(p_ref, p_got):
    """Equal keep masks; the seeded inputs have no pixel within FLIP_BAND of
    the threshold, so no flip is allowed; and the mask is no constant."""
    keep_ref, keep = p_ref <= BG_THRESHOLD, p_got <= BG_THRESHOLD
    near = np.abs(p_ref - BG_THRESHOLD) < FLIP_BAND
    assert not near.any(), f"{int(near.sum())} pixels within {FLIP_BAND}"
    np.testing.assert_array_equal(keep, keep_ref)
    assert 0.0 < keep.mean() < 1.0, keep.mean()


def test_bsm_lss_fpn(rng):
    """BSMLSSFPN through the strict bridge on the whole BSM tree: BEV and
    both semantic logits, and the keep mask."""
    cfg = _bsm_cfg(None)
    imgs, mats, *_ = make_batch(cfg, batch=2, seed=0, num_objs=2)
    jmod = JBSMLSSFPN(cfg.backbone)
    jmats = {k: jnp.asarray(v) for k, v in mats.items()}
    variables = randomize_flax(_shapes(jmod, imgs, jmats, False), seed=4)
    tree = variables["params"]
    assert {"img_backbone", "img_neck_16", "img_neck_8", "height_net"} == set(tree)
    assert "self_attention" in tree["height_net"]["depth_fpn"]
    port = BSMLSSFPN(to_port(cfg).backbone)
    port.load_state_dict(from_flax(variables), strict=True)
    port.eval()
    bev_ref, (s0_ref, s1_ref) = jax.jit(jmod.apply, static_argnums=3)(
        variables, jnp.asarray(imgs), jmats, False)
    with torch.no_grad():
        bev, (s0, s1) = port(torch.from_numpy(imgs),
                             {k: torch.from_numpy(v) for k, v in mats.items()})
    _close(_np(s0), np.asarray(s0_ref))
    _close(_np(s1), np.asarray(s1_ref))
    _close(bev.numpy(), np.asarray(bev_ref))
    assert bev.shape[-1] == cfg.backbone.output_channels + cfg.backbone.semantic_channels
    _assert_keep_masks_match(_p_background(s1_ref, True),
                             _p_background(s1.numpy(), False))


@pytest.mark.parametrize("top_k", [4, None], ids=["topk_cull", "all_bin"])
def test_bsm_predictor_matches_jax(top_k):
    cfg = _bsm_cfg(top_k)
    imgs, mats, *_ = make_batch(cfg, batch=2, seed=0, num_objs=2)
    variables = _variables(cfg, imgs, mats, seed=0)
    ref = JaxPredictor(cfg, variables, use_bf16=False)
    port = BEVHeightPredictor(to_port(cfg), from_flax(variables), device="cpu")

    jmats = {k: jnp.asarray(v) for k, v in mats.items()}
    cells, pix = ref._rig_cells(mats, jmats)
    heads_ref, (_, s1_ref) = ref.model.apply(
        ref.variables, jnp.asarray(imgs), jmats, False, cells=cells, pix_keep=pix)
    with torch.inference_mode():
        heads, (_, s1) = port.model(*port._inputs(imgs, mats))
    if top_k is not None:       # static rig with the cull, on both sides
        pix_ref, pix = ref._cells[1], port._cells[1]
        assert pix is not None and pix.numel() < np.prod(cfg.backbone.feat_hw)
        np.testing.assert_array_equal(pix.numpy(), np.asarray(pix_ref))
    _assert_keep_masks_match(_p_background(s1_ref, True),
                             _p_background(s1.numpy(), False))
    for task_ref, task in zip(heads_ref, heads):
        assert task_ref.keys() == task.keys()
        for name in task_ref:
            r, g = np.asarray(task_ref[name]), task[name].numpy()
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-3 * np.abs(r).max(), err_msg=name)
    dets_ref, dets = ref(imgs, mats), port(imgs, mats)
    assert sum(len(d[0]) for d in dets_ref) > 0
    for r, g in zip(dets_ref, dets):
        for a, b in ((r, g), (g, r)):
            m = chip_smoke.match_sets(a, b, tol=1e-3)
            assert m["unmatched"] == 0, m
