"""``batch_p95_ms``: the 95th percentile of the host-clock time of each
``query_batch`` call of the window (each ends in its answers' copy to
the host), in milliseconds; linear interpolation between order
statistics, the arithmetic of the port's ``obs.metrics.percentiles``."""

import numpy as np


def read(rec):
    lat = rec.get("batch_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95.0)) * 1e3
