"""frame step: device-busy time of a live frame."""


def read(t, cell):
    """The union of the traced stretch's device operations, in ms a
    frame."""
    if not t.frames or not t.device:
        return None
    return t.busy_us() / t.frames / 1e3
