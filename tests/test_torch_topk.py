"""Kernel K1 (top-k with cells): the port's plain version against the TPU
kernel `pallas_topk_with_cells` (interpret mode on the CPU) and against
`lax.top_k` + `take_along_axis`. Exact: values and cells bit for bit,
ties to the lowest bin. The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgv3d_tpu.ops.pallas_topk import pallas_topk_with_cells
from sgv3d_tpu.ops.voxel_pooling import topk_lift_inputs_hwd as jax_topk
from sgv3d_tpu_torch.ops.topk_cells import topk_cells_plain, topk_with_cells
from sgv3d_tpu_torch.ops.voxel_pooling import topk_lift_inputs_hwd


def _inputs(rng, kind, n=2, hw=700, d=90):
    # hw = 700 is no multiple of the Pallas kernel's 512-row tile
    if kind == "normal":
        h = rng.normal(size=(n, hw, d))
    elif kind == "ascending":   # every bin beats the ones before it
        h = np.sort(rng.normal(size=(n, hw, d)), axis=-1)
    else:       # quantised: most rows hold many exact ties
        h = rng.integers(0, 5, size=(n, hw, d)) / 4.0
    cells = rng.integers(0, 16385, size=(n, hw, d))
    return h.astype(np.float32), cells.astype(np.int32)


@pytest.mark.parametrize("kind,d,k", [
    pytest.param("normal", 90, 16, id="normal"),
    pytest.param("ties", 90, 16, id="ties"),
    pytest.param("ascending", 90, 16, id="ascending"),   # the insertion's worst case
    pytest.param("normal", 90, 1, id="k1"),
    pytest.param("normal", 33, 32, id="k32_d33")])
def test_plain_matches_pallas_and_lax(rng, kind, d, k):
    h, c = _inputs(rng, kind, d=d)
    v_port, c_port = topk_cells_plain(torch.from_numpy(h), torch.from_numpy(c), k)
    v_pl, c_pl = pallas_topk_with_cells(jnp.asarray(h), jnp.asarray(c), k, True)
    v_lax, c_lax = jax_topk(jnp.asarray(h), jnp.asarray(c), k, "exact")
    assert v_port.shape == (2, k, 700) and c_port.dtype == torch.int32
    for v, cc in ((v_pl, c_pl), (v_lax, c_lax)):
        np.testing.assert_array_equal(v_port.numpy(), np.asarray(v))
        np.testing.assert_array_equal(c_port.numpy(), np.asarray(cc))


def test_wrapper_on_cpu_is_the_plain_version(rng):
    h, c = _inputs(rng, "ties", hw=64)
    got = topk_with_cells(torch.from_numpy(h), torch.from_numpy(c), 16)
    ref = topk_cells_plain(torch.from_numpy(h), torch.from_numpy(c), 16)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):      # neither the CPU nor a card
        topk_with_cells(torch.from_numpy(h).to("meta"),
                        torch.from_numpy(c).to("meta"), 16)


def test_topk_lift_inputs_keep_all_when_k_covers_d(rng):
    h, c = _inputs(rng, "normal", hw=32, d=8)
    got_h, got_c = topk_lift_inputs_hwd(torch.from_numpy(h), torch.from_numpy(c), 8)
    ref_h, ref_c = jax_topk(jnp.asarray(h), jnp.asarray(c), 8)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
