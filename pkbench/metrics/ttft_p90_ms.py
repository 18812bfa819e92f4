"""90th percentile, over every request submitted in the window, of its
first token's host time minus its submit time, in ms. (A 51-second window
holds about 130 long-document requests: the 90th percentile is the
highest with ten or more of them beyond it.)"""

import numpy as np


def read(record):
    if record["mode"] != "serve" or not record["serve"]["ttft_s"]:
        return None
    return 1e3 * float(np.percentile(record["serve"]["ttft_s"], 90))
