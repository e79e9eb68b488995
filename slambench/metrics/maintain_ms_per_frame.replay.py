"""frame step: device time of feature maintenance, ``update_features`` (the
``maintain`` mark) a replayed frame, in ms.

The stage marks' accumulators (``ops/vision.stage_times``, the card's
``%globaltimer``) over the frames they marked unprofiled: the profiled
stretch's marks, read from the trace, taken out. Nothing where the program
marks no stages."""

from slambench import program


def read(t, cell):
    return program.stage_ms_per_frame(t, "maintain")
