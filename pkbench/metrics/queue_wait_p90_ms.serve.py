"""90th percentile, over the requests the engine admitted in the window,
of the host time from submit to admission, in ms (the port's counter
``engine.queue_wait_s``): the part of the TTFT spent queued behind other
prefills."""

import numpy as np

from pkbench.harness import spans


def read(record):
    waits = [w for s in spans.steps(record, None) or ()
             for w in s["queue_wait_s"]]
    return 1e3 * float(np.percentile(waits, 90)) if waits else None
