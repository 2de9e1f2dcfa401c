"""Faults planted under the timed path's `fetch`, for the check that
`correct` comes out false when the served answers are wrong: the CPU tests
run them at a tiny size and `control --fault` on the card at the cell's
own. Each takes one batch's per-frame [boxes, scores, labels] and returns
what a broken program would have served."""
from __future__ import annotations

import numpy as np


class Broken:
    """The predictor with `fault` applied to every batch it returns."""

    def __init__(self, pred, fault):
        self.pred, self.fault = pred, fault

    def submit(self, *args):
        return self.pred.submit(*args)

    def fetch(self, handle):
        return self.fault([[np.array(a) for a in d] for d in self.pred.fetch(handle)])


def half_left_out(dets):
    """The second half of the batch gets no detections."""
    empty = [np.zeros((0, 9), np.float32), np.zeros(0, np.float32), np.zeros(0, np.int64)]
    return dets[:len(dets) // 2] + [empty] * (len(dets) - len(dets) // 2)


def answer_altered(dets):
    """Every frame's best box moved 2 m along x where it is produced."""
    for boxes, scores, _ in dets:
        if len(scores):
            boxes[int(np.argmax(scores)), 0] += 2.0
    return dets


def frames_swapped(dets):
    """The batch's answers handed back in reverse frame order."""
    return dets[::-1]


FAULTS = {f.__name__: f for f in (half_left_out, answer_altered, frames_swapped)}
