"""Frames recorded in the window over all of the window's wall time (the
host clock from before the first dispatch to after the last record, the
card synchronized at both ends)."""


def read(win, setup_s):
    return win.frames / win.wall_s
