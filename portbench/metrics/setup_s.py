"""Process start to the first timed call: imports, seeded weights, the
model, inputs and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
