"""The plain reference against the program on the CPU: the same state_dict
names and shapes at the cells' full widths, the same dense head outputs at
a tiny size in float32, the control's decode against the program's, and
the seeded weights' determinism."""
from __future__ import annotations

import pytest
import torch

from portbench import check, inputs, program, spec, weights
from portbench.reference.decode import decode_frame
from portbench.reference.model import Detector

DATA = spec.HERE / "tests" / "data"


@pytest.mark.parametrize("config", ["bevheight_dair_r101_128", "sgv3d_r50_128"])
def test_state_dict_is_the_programs(config):
    from sgv3d_tpu_torch.models.bev_height import BEVHeight

    cfg = spec.load_json("configs", config)
    with torch.device("meta"):
        ours = Detector(cfg["exp"]).state_dict()
        theirs = BEVHeight(program.exp_config(cfg["exp"])).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}


def _served_fp32(name, seed, frames=3):
    cfg = spec.load_json("configs", name, DATA)
    cfg = {**cfg, "serving": {**cfg["serving"], "use_bf16": False}}
    dev = torch.device("cpu")
    with torch.device("meta"):
        shapes = weights.names_shapes(Detector(cfg["exp"]))
    pred = program.predictor(cfg, weights.draw(shapes, seed, dev), dev)
    rigs = inputs.rigs(seed, frames, cfg["exp"]["backbone"]["final_dim"])
    pool = inputs.frame_pool(seed, 1, frames, cfg["exp"]["backbone"]["final_dim"], dev)
    mats = inputs.batch_mats(rigs)
    heads = pred.predict_heads(pool[0].numpy(), mats)
    dets = pred(pool[0].numpy(), mats)
    model = check.reference_model(cfg["exp"], seed, dev)
    refs = check.reference_outputs(model, [pool[0, i, 0, 0] for i in range(frames)], rigs, dev)
    return cfg, heads, dets, refs


@pytest.mark.parametrize("name", ["tiny", "tiny_bsm"])
def test_reference_heads_match_the_program_in_float32(name):
    _, heads, _, refs = _served_fp32(name, 20261018)
    for i, ref in enumerate(refs):
        for t, task in enumerate(heads):
            for k, v in task.items():
                scale = float(v.abs().max())
                assert float((v[i] - ref[t][k]).abs().max()) <= 1e-5 * scale, (name, i, t, k)


@pytest.mark.parametrize("name", ["tiny", "tiny_bsm"])
def test_reference_decode_matches_the_programs(name):
    cfg, _, dets, refs = _served_fp32(name, 99)
    for served, ref in zip(dets, refs):
        boxes, scores, labels = decode_frame(cfg["exp"]["head"], ref)
        assert sorted(labels.tolist()) == sorted(served[2].tolist())
        assert torch.allclose(torch.sort(torch.as_tensor(scores)).values,
                              torch.sort(torch.as_tensor(served[1])).values, atol=1e-5)


def test_weights_are_a_function_of_the_seed():
    cfg = spec.load_json("configs", "tiny", DATA)
    with torch.device("meta"):
        shapes = weights.names_shapes(Detector(cfg["exp"]))
    a, b = (weights.draw(shapes, 2**33 + 5, torch.device("cpu")) for _ in range(2))
    c = weights.draw(shapes, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.shared_conv.conv.weight"], c["head.shared_conv.conv.weight"])
    var = [v for k, v in a.items() if k.endswith("running_var")]
    assert all(float(v.min()) >= 0.5 and float(v.max()) <= 1.5 for v in var)


def test_inputs_are_a_function_of_the_seed():
    dim = (64, 96)
    r1, r2 = inputs.rigs(2**31 + 11, 4, dim), inputs.rigs(2**31 + 11, 4, dim)
    assert all((r1[i][k] == r2[i][k]).all() for i in range(4) for k in r1[i])
    assert not (r1[0]["intrin_mats"] == r1[1]["intrin_mats"]).all()
    p1 = inputs.frame_pool(2**31 + 11, 2, 3, dim, torch.device("cpu"))
    p2 = inputs.frame_pool(2**31 + 11, 2, 3, dim, torch.device("cpu"))
    assert torch.equal(p1, p2) and p1.dtype == torch.uint8
    assert not torch.equal(p1[0, 0], p1[0, 1])
