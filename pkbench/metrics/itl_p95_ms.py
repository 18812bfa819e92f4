"""95th percentile of every gap between two consecutive tokens of a
request whose later token came in the window, in ms."""

import numpy as np


def read(record):
    if record["mode"] != "serve" or not record["serve"]["itl_s"]:
        return None
    return 1e3 * float(np.percentile(record["serve"]["itl_s"], 95))
