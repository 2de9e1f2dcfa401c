"""SGV3D cell: images whose detections reached the host in the window, a second
(host clock over the whole window, first submit to last readback)."""


def read(run):
    w = run.window
    return w.completed / w.seconds if w.completed and w.seconds > 0 else None
