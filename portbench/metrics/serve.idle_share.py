"""Share (%) of the traced window with no kernel, copy or fill running."""
from portbench.readers import idle_share


def read(run):
    return idle_share(run)
