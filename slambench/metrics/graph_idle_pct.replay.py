"""frame step: idle share inside a replay, in %.

In the profiled trace, each replay runs from its ``start`` stage mark to
its last mark; the share of that time in which no device operation runs.
Under the profiler a replay is also fed to the card by its own
``cudaGraphLaunch``, which the profiler slows, so at M = 32 this reads
mostly the card waiting for that launch (PERF.md). Nothing where the trace
holds no marks.
"""

from slambench import program


def read(t, cell):
    reps = program.replays(t)
    inside = sum(b - a for a, b in reps)
    if inside <= 0:
        return None
    return 100.0 * (1.0 - program.busy_within(t, reps) / inside)
