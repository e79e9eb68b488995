"""device (one H100): idle share of a replayed frame."""


def read(t, cell):
    """100 x (1 - device-busy time a frame / wall time a frame): the busy
    time the union of the traced stretch's device operations, the wall time
    that of the same frames from the same state run just before without the
    profiler (which slows the host)."""
    if not t.frames or not t.device:
        return None
    busy = t.busy_us() / t.frames
    return 100.0 * (1.0 - busy / t.wall_us_per_frame)
