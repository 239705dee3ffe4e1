"""The 95th percentile (nearest rank) of every batch of the window, from
handing the batch to the port until its result is on the host. Each batch
is bounded by two CUDA events recorded on the idle stream, at the hand-off
and once the result is read, and read with the device's clock."""

import math


def read(run):
    lat = sorted(run.latencies_ms)
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
