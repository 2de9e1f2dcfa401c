"""`runner.evaluate` takes every val frame exactly once: after the gather
(one rank, or `all_gather_object` + `interleave_shards` under a group) it
must hold `len(dataset)` results, and raises on fewer. The planted fault
drops each rank's last frame, so the shards stay equal in length (the
check `interleave_shards` makes) but the gather is one frame a rank short.
A fake predictor, loader and evaluator stand in for the card, the data
and the C++ evaluator, so the test needs neither."""
import numpy as np
import pytest

import chip_smoke
from sgv3d_tpu_torch import dist, runner

FRAMES = 6


class _Predictor:
    def submit(self, imgs, mats):
        return len(imgs)

    def fetch(self, n):
        return [(np.zeros((0, 9)), np.zeros(0), np.zeros(0))] * n


def _loader(frames, batch):
    out = []
    for i in range(0, len(frames), batch):
        ids = frames[i:i + batch]
        out.append((np.zeros((len(ids), 1, 1, 2, 2, 3), np.uint8),
                    {"ida_mats": np.zeros((len(ids), 1, 1, 4, 4), np.float32)},
                    None, None, None, [{"id": f} for f in ids]))
    return out


@pytest.fixture
def evaluated(monkeypatch):
    """Runs `_evaluate_state` on the frames a rank's loader yields, with a
    world of `world` ranks whose gathers all return that rank's lists;
    returns what reached the evaluator."""
    seen = {}

    class _Evaluator:
        def __init__(self, **kw):
            pass

        def evaluate(self, results, metas):
            seen.update(results=results, metas=metas)
            return 0.0, {}

    monkeypatch.setattr(runner, "RoadSideEvaluator", _Evaluator)

    def run(frames, world):
        monkeypatch.setattr(dist, "get_world_size", lambda: world)
        monkeypatch.setattr(dist, "get_rank", lambda: 0)
        monkeypatch.setattr(dist, "synchronize", lambda: None)
        monkeypatch.setattr(dist, "all_gather_object", lambda obj: [obj] * world)
        cfg = chip_smoke.tiny_exp()
        runner._evaluate_state(cfg, _Predictor(), _loader(frames, cfg.batch_size_per_device),
                               list(range(FRAMES)), "rope3d-kitti", "out")
        return seen
    return run


@pytest.mark.parametrize("world", [1, 2])
def test_whole_gather_reaches_the_evaluator(evaluated, world):
    frames = list(range(FRAMES // world))
    got = evaluated(frames, world)
    assert len(got["results"]) == len(got["metas"]) == FRAMES


@pytest.mark.parametrize("world", [1, 2])
def test_short_gather_raises(evaluated, world):
    """Each rank loses its last frame: one rank gathers 5 of 6, two ranks
    2 + 2 of 6 (equal shards)."""
    frames = list(range(FRAMES // world - 1))
    with pytest.raises(ValueError, match="gathered"):
        evaluated(frames, world)
