"""The training modules of the port against the JAX package's, on the CPU,
float32, the same numpy inputs from a seed on both sides:

- K2b's plain version (`lift_splat_backward_plain`, and `LiftSplat`'s
  autograd) against `jax.vjp` of `lift_splat_pool`: within 1e-5 of each
  gradient's scale (sums in another order);
- `get_targets`: indices and masks exactly, heatmaps within 1e-6, boxes
  within 1e-5;
- `head_loss`, `semantic_loss`, `embed_loss`, the focal, dice and
  functional losses: within 1e-5 relative;
- the optimizer: the same gradients through optax's chain and the port's
  AdamW across a milestone, clip on and off: parameters within 1e-6
  relative;
- BatchNorm in train mode: output and new running statistics as flax's
  (1e-5, and 1e-6 for the statistics; a bf16 input within bf16's rounding);
- train-mode gradients of the BEV head with the losses, and of HeightNet,
  given the same inputs: within 1e-4 of the largest leaf gradient (the
  train-mode step as a whole is held in tests/test_torch_train_step.py);
- the ASPP's dropout, the rematerialised backbone and the top-k training
  lift's refusal.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import biases_ahead_of_batchnorm
import sgv3d_tpu.heads.losses as jheads_losses
import sgv3d_tpu.losses as jlosses
from sgv3d_tpu.data.synthetic import make_batch
from sgv3d_tpu.heads.bev_head import BEVHeightHead as JaxHead
from sgv3d_tpu.heads.targets import gaussian_radius as jax_radius
from sgv3d_tpu.heads.targets import get_targets as jax_targets
from sgv3d_tpu.models import bev_height as jmodel
from sgv3d_tpu.nn.height_net import HeightNet as JaxHeightNet
from sgv3d_tpu.ops.voxel_pooling import lift_splat_pool
from sgv3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from sgv3d_tpu.train.optim import schedule_value as jax_schedule_value
import sgv3d_tpu_torch.losses as plosses
from sgv3d_tpu_torch.heads.losses import head_loss
from sgv3d_tpu_torch.heads.targets import gaussian_radius, get_targets
from sgv3d_tpu_torch.models import bev_height as pmodel
from sgv3d_tpu_torch.nn import lss_fpn
from sgv3d_tpu_torch.nn.blocks import ASPP, BatchNorm
from sgv3d_tpu_torch.nn.height_net import HeightNet
from sgv3d_tpu_torch.ops.lift_splat import LiftSplat, lift_splat_backward_plain
from sgv3d_tpu_torch.train.loop import dropout_generator
from sgv3d_tpu_torch.train.optim import AdamW, make_optimizer, schedule_value
from sgv3d_tpu_torch.weights import from_flax, random_init, to_flax
from tests.tiny_configs import tiny_exp
from tests.torch_port_util import to_port
from tests.torch_port_util import shared_jax_compiles  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().numpy()


# ---------------------------------------------------------------- K2b


@pytest.mark.parametrize("layout,j,feat_w,hw,cells", [
    ("top-k", 4, None, 37, 50), ("all-bin", 13, None, 37, 50), ("all-bin", 13, 7, 35, 50),
    ("all-bin", 180, 4, 12, 123904)],
    ids=["top-k-4", "all-bin-13", "all-bin-13-feat_w-7", "all-bin-180-cells-123904"])
def test_backward_plain_matches_jax_vjp(rng, layout, j, feat_w, hw, cells):
    """Two batch elements of two cameras each, a third of the points in the
    trash cell, D = 13 not a multiple of the JAX scan's d_chunk of 10; with
    `feat_w`, the pixels a map of that width, which `LiftSplat` carries to
    the backward (the gradients do not change with it). The last case is
    past both limits the training exps reach, J = 180 and more than 65,536
    cells (`bevheight_rope3d_r101_140m`'s 123,904), sparsely occupied: a
    3 x 4 map's 4320 points over the grid."""
    batch, n, c = 2, 4, 9
    height = rng.random((n, j, hw)).astype(np.float32)
    ctx = rng.normal(size=(n, hw, c)).astype(np.float32)
    cell = rng.integers(0, cells, size=(n, j, hw)).astype(np.int32)
    cell[rng.random(cell.shape) < 0.33] = cells
    grad = rng.normal(size=(batch, cells, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda h, x: lift_splat_pool(h, x, jnp.asarray(cell),
                                                  batch, cells),
                     jnp.asarray(height), jnp.asarray(ctx))
    ref_h, ref_c = (np.asarray(a) for a in vjp(jnp.asarray(grad)))
    d_h, d_c = lift_splat_backward_plain(_t(grad), _t(height), _t(ctx), _t(cell),
                                         batch, cells)
    np.testing.assert_allclose(_n(d_h), ref_h, rtol=0, atol=1e-5 * np.abs(ref_h).max())
    np.testing.assert_allclose(_n(d_c), ref_c, rtol=0, atol=1e-5 * np.abs(ref_c).max())
    # trash points get no height gradient
    assert np.all(_n(d_h)[cell == cells] == 0)
    # the autograd function routes the same gradients
    h, x = _t(height).requires_grad_(), _t(ctx).requires_grad_()
    LiftSplat.apply(h, x, _t(cell), batch, cells, feat_w).backward(_t(grad))
    np.testing.assert_array_equal(_n(h.grad), _n(d_h))
    np.testing.assert_array_equal(_n(x.grad), _n(d_c))


# ------------------------------------------------------------ targets


def _gt(cfg, rng, batch=3, k=None):
    """Padded boxes of every class of the tiny config's two tasks, two out
    of the BEV range, one of zero size, the rest -1 padding."""
    k = k or cfg.head.max_objs
    boxes = np.zeros((batch, k, 9), np.float32)
    labels = np.full((batch, k), -1, np.int32)
    pc = cfg.head.point_cloud_range
    for b in range(batch):
        m = 6 + b
        boxes[b, :m, 0] = rng.uniform(pc[0] + 1, pc[3] - 1, m)
        boxes[b, :m, 1] = rng.uniform(pc[1] + 1, pc[4] - 1, m)
        boxes[b, :m, 2] = rng.uniform(-2, 1, m)
        boxes[b, :m, 3:6] = rng.uniform(0.4, 5.0, (m, 3))
        boxes[b, :m, 6] = rng.uniform(-np.pi, np.pi, m)
        boxes[b, :m, 7:9] = rng.normal(size=(m, 2))
        labels[b, :m] = rng.integers(0, 3, m)
    boxes[0, 0, 0] = pc[3] + 4.0          # beyond x
    boxes[1, 1, 1] = pc[1] - 3.0          # beyond y
    boxes[-1, 2, 3] = 0.0                 # zero width
    return boxes, labels


def test_get_targets_matches_jax(rng):
    cfg = tiny_exp()
    boxes, labels = _gt(cfg, rng)
    ref = jax_targets(cfg.head, jnp.asarray(boxes), jnp.asarray(labels))
    got = get_targets(to_port(cfg).head, _t(boxes), _t(labels))
    np.testing.assert_array_equal(_n(got.inds), np.asarray(ref.inds))
    assert len(got.masks) == len(ref.masks) == 2
    for m, r in zip(got.masks, ref.masks):
        np.testing.assert_array_equal(_n(m), np.asarray(r))
    assert 0 < sum(float(m.sum()) for m in got.masks) < (labels >= 0).sum()
    np.testing.assert_allclose(_n(got.anno_boxes), np.asarray(ref.anno_boxes),
                               rtol=0, atol=1e-5)
    for h, r in zip(got.heatmaps, ref.heatmaps):
        np.testing.assert_allclose(_n(h), np.asarray(r), rtol=0, atol=1e-6)
        assert (_n(h) == 1.0).sum() == (np.asarray(r) == 1.0).sum() > 0
    dims = rng.uniform(0.1, 30, (2, 50)).astype(np.float32)
    np.testing.assert_allclose(
        _n(gaussian_radius((_t(dims[0]), _t(dims[1])), 0.1)),
        np.asarray(jax_radius((jnp.asarray(dims[0]), jnp.asarray(dims[1])), 0.1)),
        rtol=1e-6)


# ------------------------------------------------------------- losses


def _preds(cfg, rng, b=3, scale=2.0):
    h, w = cfg.head.feature_map_size[::-1]
    out = []
    for task in cfg.head.tasks:
        d = {k: rng.normal(size=(b, h, w, c)).astype(np.float32)
             for k, (c, _) in cfg.head.common_heads}
        d["heatmap"] = (rng.normal(size=(b, h, w, task.num_classes)) * scale
                        ).astype(np.float32)
        out.append(d)
    return out


def test_head_loss_and_its_gradient_match_jax(rng):
    cfg = tiny_exp()
    boxes, labels = _gt(cfg, rng)
    preds = _preds(cfg, rng)

    def jax_loss(p):
        t = jax_targets(cfg.head, jnp.asarray(boxes), jnp.asarray(labels))
        return jheads_losses.head_loss(cfg.head, t, p)

    (ref, ref_m), ref_g = jax.value_and_grad(jax_loss, has_aux=True)(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in preds])
    tp = [{k: _t(v).requires_grad_() for k, v in d.items()} for d in preds]
    pcfg = to_port(cfg)
    got, got_m = head_loss(pcfg.head, get_targets(pcfg.head, _t(boxes), _t(labels)), tp)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert set(got_m) == set(ref_m)
    for k in ref_m:
        np.testing.assert_allclose(got_m[k].item(), float(ref_m[k]), rtol=1e-5, err_msg=k)
    for d, r in zip(tp, ref_g):
        for k in d:
            rk = np.asarray(r[k])
            np.testing.assert_allclose(_n(d[k].grad), rk, rtol=0,
                                       atol=1e-5 * max(np.abs(rk).max(), 1e-6))


def test_semantic_and_embed_losses_match_jax(rng):
    cfg = tiny_exp(is_bsm=True)
    bn, s = 2, cfg.backbone.semantic_channels
    h, w = cfg.backbone.final_dim
    f = cfg.backbone.downsample_factor
    sem0 = rng.normal(size=(bn, h // f, w // f, s)).astype(np.float32)
    sem1 = rng.normal(size=(bn, 2 * h // f, 2 * w // f, s)).astype(np.float32)
    gt = rng.integers(0, s, size=(2, 1, h, w)).astype(np.int32)
    ref = jmodel.semantic_loss(cfg, (jnp.asarray(sem0), jnp.asarray(sem1)),
                               jnp.asarray(gt))
    got = pmodel.semantic_loss(to_port(cfg), (_t(sem0.transpose(0, 3, 1, 2)),
                                              _t(sem1.transpose(0, 3, 1, 2))), _t(gt))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_array_equal(
        _n(pmodel.downsample_semantic_labels(_t(gt), 8)),
        np.asarray(jmodel.downsample_semantic_labels(jnp.asarray(gt), 8)))
    assist = rng.normal(size=(bn, 4, 6, 256)).astype(np.float32)
    embeds = rng.normal(size=(2, 1, 4, 6, 256)).astype(np.float32)
    ref = jmodel.embed_loss((jnp.asarray(assist),) * 2, jnp.asarray(embeds))
    got = pmodel.embed_loss((_t(assist.transpose(0, 3, 1, 2)),) * 2, _t(embeds))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_focal_dice_and_functional_losses_match_jax(rng):
    logits = (rng.normal(size=(2, 5, 7, 4)) * 3).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 5, 7)).astype(np.int32)
    labels[0, 0, :3] = 255
    binary = (rng.random((2, 5, 7, 4)) < 0.3).astype(np.float32)
    cases = [
        ("multiclass_focal_loss", (logits, labels), {}),
        ("multiclass_focal_loss", (logits, labels), {"ignore_index": 255}),
        ("binary_focal_loss_with_logits", (logits, binary), {"alpha": None}),
        ("multilabel_focal_loss", (logits, binary), {"reduction": "sum"}),
        ("focal_loss", (logits, labels), {"mode": "multiclass", "ignore_index": 255}),
        ("dice_loss", (1 / (1 + np.exp(-logits)), binary), {}),
        ("dice_loss_modes", (logits, labels), {"mode": "multiclass", "ignore_index": 255}),
        ("dice_loss_modes", (logits, binary), {"mode": "multilabel", "log_loss": True}),
        ("dice_loss_modes", (logits[..., :1], binary[..., :1]), {"mode": "binary"}),
        ("soft_jaccard_score", (1 / (1 + np.exp(-logits)), binary), {"dims": (0, 1)}),
        ("soft_tversky_score", (1 / (1 + np.exp(-logits)), binary, 0.3, 0.7), {}),
        ("wing_loss", (logits, binary * 8), {}),
        ("label_smoothed_nll_loss", (np.log(np.clip(1 / (1 + np.exp(-logits)), 1e-3, 1)),
                                     labels.clip(0, 3), 0.1), {}),
        ("softmax_focal_loss_with_logits", (logits, labels.clip(0, 3)), {}),
    ]
    for name, args, kw in cases:
        ref = getattr(jlosses, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                       else a for a in args), **kw)
        got = getattr(plosses, name)(*(_t(a) if isinstance(a, np.ndarray) else a
                                       for a in args), **kw)
        np.testing.assert_allclose(_n(got), np.asarray(ref), rtol=1e-5, atol=1e-7,
                                   err_msg=f"{name} {kw}")


# ---------------------------------------------------------- optimizer


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_optimizer_matches_optax_across_a_milestone(rng, clip):
    """Six steps with 2 steps an epoch and milestones at epochs 1 and 2, so
    the LR drops twice; gradients large enough that the clip at 5 acts
    (or, with clip off, a max norm far above them)."""
    cfg = dataclasses.replace(tiny_exp(), lr_milestones=(1, 2),
                              grad_clip=5.0 if clip else 1e9)
    tx, _ = jax_make_optimizer(cfg, 1, 2)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * (3 if i % 2 else 0.05)).astype(np.float32)
              for s in shapes] for i in range(6)]
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [_t(p) for p in params]
    opt = make_optimizer(to_port(cfg), tp, 1, 2)
    for i, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([_t(a) for a in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert opt.count == 6
    for step in range(7):
        assert schedule_value(to_port(cfg), 1, 2, step) == pytest.approx(
            jax_schedule_value(cfg, 1, 2, step), rel=1e-12)
    # the optimizer's state round-trips
    other = AdamW([p.clone() for p in tp], opt.schedule, cfg.weight_decay, 5.0)
    other.load_state_dict(opt.state_dict())
    assert other.count == 6 and all(torch.equal(a, b) for a, b in zip(other.nu, opt.nu))


# --------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("shape,momentum", [((3, 5, 4, 6), 0.9), ((4, 27), 0.9),
                                            ((2, 5, 3, 3), 0.99)])
def test_batchnorm_train_mode_matches_flax(rng, shape, momentum):
    x = (rng.normal(size=shape) * 2 + 0.7).astype(np.float32)
    c = shape[1]
    scale = (1 + rng.normal(size=c) * 0.2).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32) * 0.1
    mean = rng.normal(size=c).astype(np.float32) * 0.3
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    nhwc = x if x.ndim == 2 else x.transpose(0, 2, 3, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    ref, new = bn.apply(variables, jnp.asarray(nhwc), mutable=["batch_stats"])
    ref = np.asarray(ref)
    if x.ndim == 4:
        ref = ref.transpose(0, 3, 1, 2)
    port = BatchNorm(c, momentum=momentum)
    port.load_state_dict(from_flax({"params": variables["params"],
                                    "batch_stats": variables["batch_stats"]}))
    port.train()
    out = port(_t(x))
    np.testing.assert_allclose(_n(out), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_n(port.running_mean),
                               np.asarray(new["batch_stats"]["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_n(port.running_var),
                               np.asarray(new["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    # a bf16 input: statistics in float32, the output in bf16, as flax's
    # BatchNorm(dtype=bf16) computes them
    bn16 = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                         epsilon=1e-5, dtype=jnp.bfloat16)
    ref16, new16 = bn16.apply(variables, jnp.asarray(nhwc, jnp.bfloat16),
                              mutable=["batch_stats"])
    port16 = BatchNorm(c, momentum=momentum)
    port16.load_state_dict(port.state_dict() | {
        "running_mean": _t(mean), "running_var": _t(var)})
    port16.train()
    out16 = port16(_t(x).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16
    ref16 = np.asarray(ref16.astype(jnp.float32))
    if x.ndim == 4:
        ref16 = ref16.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(_n(out16.float()), ref16, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_n(port16.running_var),
                               np.asarray(new16["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    # eval mode normalises by the running statistics and leaves them
    port.eval()
    before = port.running_mean.clone()
    port(_t(x))
    assert torch.equal(port.running_mean, before)


# ------------------------------------- train-mode gradients, module by module


def _leaf_grads_close(port_module, jax_grads):
    """Each leaf within 1e-4 of its own max |g|; a conv bias ahead of a
    train-mode BatchNorm (zero in exact arithmetic) within 1e-6 of the
    largest leaf gradient on both sides."""
    ref = from_flax({"params": jax.device_get(jax_grads)})
    top = max(float(g.abs().max()) for g in ref.values())
    zero = biases_ahead_of_batchnorm(port_module)
    assert zero
    for name, p in port_module.named_parameters():
        if name in zero:
            assert max(float(p.grad.abs().max()),
                       float(ref[name].abs().max())) <= 1e-6 * top, name
            continue
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-4 * float(ref[name].abs().max()), (name, err)


def test_head_and_loss_train_gradients_match_jax(rng):
    """The BEV head in train mode with `train_loss` on top, from the same
    BEV map (dense, so that its BatchNorms are well conditioned)."""
    cfg = tiny_exp()
    boxes, labels = _gt(cfg, rng, batch=2)
    bev = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    port_model = pmodel.BEVHeight(to_port(cfg))
    random_init(port_model, 1)
    variables = to_flax(port_model)
    head_vars = {c: v["head"] for c, v in variables.items()}
    jhead = JaxHead(cfg.head)

    def jax_loss(params, x):
        preds, _ = jhead.apply({"params": params,
                                "batch_stats": head_vars["batch_stats"]}, x, True,
                               mutable=["batch_stats"])
        return jmodel.train_loss(cfg, preds, None, jnp.asarray(boxes),
                                 jnp.asarray(labels))[0]

    ref, (g_params, g_bev) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, head_vars["params"]), jnp.asarray(bev))
    head = port_model.head.train()
    x = _t(bev).requires_grad_()
    loss, _ = pmodel.train_loss(to_port(cfg), head(x), None, _t(boxes), _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(_n(x.grad), np.asarray(g_bev), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(g_bev)).max())
    _leaf_grads_close(head, g_params)


def test_height_net_train_gradients_match_jax(rng):
    """HeightNet in train mode (BN batch statistics, the ASPP with dropout
    off, the DCN) from the same input and camera vectors; four unlike
    frames, so that the ASPP's global branch (a BatchNorm over the frames'
    pooled vectors) is well conditioned: over two vectors its backward is
    all cancellation, and its conv's gradient then agrees only to ~1e-3."""
    cin, mid, ctx_c, bins = 32, 32, 16, 8
    x = rng.normal(size=(4, 4, 6, cin)).astype(np.float32)
    for i in range(1, 4):
        x[i] = x[i] * (1.0 - 0.2 * i) + 0.6 * i
    mlp = rng.normal(size=(4, 27)).astype(np.float32)
    w_h = rng.normal(size=(4, 4, 6, bins)).astype(np.float32)
    w_c = rng.normal(size=(4, 4, 6, ctx_c)).astype(np.float32)
    port = HeightNet(cin, mid, ctx_c, bins)
    random_init(port, 0)
    variables = to_flax(port)
    jnet = JaxHeightNet(mid_channels=mid, context_channels=ctx_c, height_channels=bins)

    def jax_loss(params, xx):
        with_dropout_off = {"params": params, "batch_stats": variables["batch_stats"]}
        (h, c), _ = jnet.apply(with_dropout_off, xx, jnp.asarray(mlp), True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(h * w_h) + jnp.sum(c * w_c)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, v, *a, **k: v)
        g_params, g_x = jax.grad(jax_loss, argnums=(0, 1))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x))
    port.train()
    port.aspp.dropout_p = 0.0
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_()
    h, c = port(xt, _t(mlp))
    ((h.permute(0, 2, 3, 1) * _t(w_h)).sum()
     + (c.permute(0, 2, 3, 1) * _t(w_c)).sum()).backward()
    np.testing.assert_allclose(_n(xt.grad.permute(0, 2, 3, 1)), np.asarray(g_x),
                               rtol=0, atol=1e-4 * np.abs(np.asarray(g_x)).max())
    _leaf_grads_close(port, g_params)


# ---------------------------------------------- dropout, remat, refusals


def test_aspp_dropout_is_seeded_scaled_and_train_only():
    torch.manual_seed(0)
    aspp = ASPP(8, 8)
    x = torch.randn(2, 8, 5, 7)
    aspp.eval()
    ref = aspp(x)
    aspp.train()
    outs = []
    for step in (3, 3, 4):
        aspp.generator = dropout_generator(11, step, "cpu")
        outs.append(aspp(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    aspp.generator = None
    aspp.dropout_p = 0.0
    full = aspp(x)
    kept = outs[0] != 0
    np.testing.assert_allclose(_n(outs[0][kept]), _n(full[kept] * 2), rtol=1e-6)
    share = float((full != 0).float().mean())
    assert 0.4 * share < float(kept.float().mean()) < 0.6 * share
    assert ref.shape == full.shape


def _tiny_backbone_grads(cfg, remat: bool):
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, remat_backbone=remat))
    model = pmodel.BEVHeight(cfg)
    random_init(model, 3)
    model.train()
    for m in model.modules():
        if isinstance(m, ASPP):
            m.dropout_p = 0.0
    imgs, mats, *_ = make_batch(cfg, batch=2, num_objs=2, max_objs=4, seed=1)
    preds, _ = model(_t(imgs), {k: _t(v) for k, v in mats.items()}, train=True)
    sum(p["heatmap"].square().sum() + p["reg"].sum() for p in preds).backward()
    return ({n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()})


def test_remat_backbone_gives_the_same_gradients_and_one_stats_update():
    cfg = to_port(tiny_exp())
    g0, b0 = _tiny_backbone_grads(cfg, remat=False)
    g1, b1 = _tiny_backbone_grads(cfg, remat=True)
    assert g0.keys() == g1.keys() and any(n.startswith("backbone.img_backbone")
                                          for n in g0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-7)
    for name in b0:
        assert torch.equal(b1[name], b0[name]), name


def test_top_k_training_lift_raises():
    """The top-k training lift trains: its forward picks through
    `TopkCells` and a backward reaches the image side; pixel culling, which
    applies to precomputed culled cells only, still raises without them."""
    cfg = to_port(tiny_exp())
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, train_lift_top_k=4))
    model = pmodel.BEVHeight(cfg).train()
    imgs, mats, *_ = make_batch(cfg, batch=1, num_objs=1, max_objs=2)
    mats = {k: _t(v) for k, v in mats.items()}
    preds, _ = model(_t(imgs), mats, train=True)
    sum(t.float().square().sum() for task in preds for t in task.values()).backward()
    # the height layer reaches the loss only through the top-k pick
    grad = model.backbone.height_net.height_layer.weight.grad
    assert grad is not None and float(grad.abs().max()) > 0
    assert lss_fpn._lift_k(cfg.backbone, True) == 4
    assert lss_fpn._lift_k(cfg.backbone, False) is None
    with pytest.raises(ValueError, match="culled cells"):
        model(_t(imgs), mats, pix_keep=torch.zeros(8, dtype=torch.long),
              train=True)
