"""The gather probe (K4) of the port on the CPU: each formulation's plain
version is exactly numpy's `ctx[idx]`, the JAX probe's own oracle
(tools/spike_pallas_gather.py)."""
import numpy as np
import pytest
import torch

from sgv3d_tpu_torch.tools import spike_gather


@pytest.mark.parametrize("name,fn", spike_gather.FORMULATIONS)
def test_gather_plain_is_numpy_take(name, fn):
    ctx, idx = spike_gather.probe_inputs("cpu", seed=3)
    assert ctx.shape == (spike_gather.HW, spike_gather.C)
    assert idx.shape == (spike_gather.N_CHUNKS, spike_gather.M)
    before = fn.launches
    got = fn(ctx, idx)
    assert fn.launches == before          # the CPU runs no kernel
    ref = ctx.float().numpy()[idx.numpy()]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_probe_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert spike_gather.main() == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
