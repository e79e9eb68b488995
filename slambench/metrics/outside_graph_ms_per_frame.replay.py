"""session: time a frame outside the replayed graph, in ms.

The session's host wall time a frame, unprofiled (the program's outermost
spans, ``slam.run`` or ``slam.step``, graph captures left out but the wait
before each kept, over the ``frames`` counter), less the in-graph time a
frame (the stage marks' accumulators, from each replay's ``start`` to its
last mark, the profiled stretch's marks taken out): the host path, the
copies and the waits between replays. Nothing where the program keeps no
spans or marks.
"""

from slambench import program


def read(t, cell):
    return program.outside_graph_ms_per_frame(t)
