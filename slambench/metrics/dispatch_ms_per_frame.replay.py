"""session: host time of a chunk's dispatch a recorded frame, in ms.

The program's ``slam.dispatch`` span (``SlamSession._dispatch_chunk``: the
detect decision, the window, the replay's launch, the telemetry fetch's
launch, the next window's prefetch) less the graph captures inside it, over
the ``frames`` counter, unprofiled. Nothing where the program has no
spans or the run saw no device."""

from slambench import program


def read(t, cell):
    return program.span_ms_per_frame(t, "slam.dispatch", "slam.capture")
