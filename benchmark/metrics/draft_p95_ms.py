"""The 95th percentile (numpy's linear interpolation) of the argv-to-PNG
latency of every render in the window, in milliseconds (host clock)."""
import numpy as np


def read(rec):
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in rec["renders"]]
    return float(np.percentile(lat, 95)) if lat else None
