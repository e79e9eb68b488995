"""session: host time of a live step, waits and captures left out, in ms.

The program's ``slam.step`` span (``SlamSession.step``) less the
``slam.wait`` on its telemetry and the ``slam.capture`` inside it, over the
``frames`` counter, unprofiled. Nothing where the program has no spans
or the run saw no device."""

from slambench import program


def read(t, cell):
    return program.span_ms_per_frame(t, "slam.step", "slam.wait",
                                     "slam.capture")
