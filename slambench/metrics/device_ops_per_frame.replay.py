"""session: device operations of a replayed frame."""


def read(t, cell):
    """Device operations (kernels, copies, sets; a graph's nodes one by
    one) a frame of the traced stretch."""
    if not t.frames or not t.device:
        return None
    return len(t.device) / t.frames
