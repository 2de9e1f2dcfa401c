"""Does a frame's output depend on the batch it sits in (ROADMAP C4)? The
tiny BEVHeight, float32 on the CPU, the same randomised weights in both
packages: four seeded frames as one batch of 4 and as two batches of 2,
each package's per-frame head tensors compared between the two batchings.

The port's plain path (CPU convolutions, the lift's `index_add_`, which
sums each cell in point order within a frame) may differ between
batchings only by the float32 rounding of convolutions that choose their
algorithm by batch: within BATCH_TOL of each tensor's scale, or within
JAX's own difference where that is larger. Both differences are printed.
On the card the lift's kernels are held to bitwise invariance
(`chip_smoke.lift_batch_invariance`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgv3d_tpu.api import BEVHeightPredictor as JaxPredictor
from sgv3d_tpu.data.synthetic import make_batch
from sgv3d_tpu.models.bev_height import BEVHeight as JaxBEVHeight
from sgv3d_tpu_torch.api import BEVHeightPredictor
from sgv3d_tpu_torch.weights import from_flax
from tests.tiny_configs import tiny_exp
from tests.torch_port_util import randomize_flax, to_port

BATCH_TOL = 1e-5     # float32 sums in another order, through ~40 layers
FRAMES = 4


def _batch_diff(heads_whole, heads_halves) -> float:
    """The largest per-frame difference over each head tensor's scale."""
    worst = 0.0
    for i, task in enumerate(heads_whole):
        for key, ref in task.items():
            ref = np.asarray(ref, np.float64)
            part = np.concatenate([np.asarray(h[i][key], np.float64)
                                   for h in heads_halves])
            worst = max(worst, float(np.abs(part - ref).max() / np.abs(ref).max()))
    return worst


def test_port_batch_dependence_no_more_than_jax():
    """Parity-grade: the exact all-bin lift, as `runner.evaluate` runs it."""
    cfg = tiny_exp()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, lift_top_k=None))
    imgs, mats, *_ = make_batch(cfg, batch=FRAMES, seed=3, num_objs=2)
    shapes = jax.eval_shape(
        lambda x, m: JaxBEVHeight(cfg).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            x, m, False),
        jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in mats.items()})
    variables = randomize_flax(shapes, 0)
    ref = JaxPredictor(cfg, variables, use_bf16=False, static_rig=False)
    port = BEVHeightPredictor(to_port(cfg), from_flax(variables), device="cpu",
                              static_rig=False)

    def jax_heads(sl):
        jmats = {k: jnp.asarray(v[sl]) for k, v in mats.items()}
        preds, _ = ref.model.apply(ref.variables, jnp.asarray(imgs[sl]), jmats, False)
        return [{k: np.asarray(v) for k, v in t.items()} for t in preds]

    def port_heads(sl):
        with torch.no_grad():
            out = port.predict_heads(imgs[sl], {k: v[sl] for k, v in mats.items()})
        return [{k: v.numpy() for k, v in t.items()} for t in out]

    halves = (slice(0, 2), slice(2, 4))
    jax_diff = _batch_diff(jax_heads(slice(0, 4)), [jax_heads(s) for s in halves])
    port_diff = _batch_diff(port_heads(slice(0, 4)), [port_heads(s) for s in halves])
    print(f"batch 4 against 2 + 2, largest per-frame head difference over "
          f"scale: JAX {jax_diff:.3e}, port {port_diff:.3e}")
    assert port_diff <= max(jax_diff, BATCH_TOL)
