"""The recurrences (``ops/csrc/scan_kernels.cu``: ``store_slots``,
``gftt_greedy_nms``): their device time a replayed frame (0 where neither
ran in the traced stretch)."""

KERNELS = ("store_slots_kernel", "gftt_greedy_nms_kernel")


def read(t, cell):
    if not t.frames or not t.device:
        return None
    return sum(t.kernel_us(lambda n: any(k in n for k in KERNELS))) \
        / t.frames / 1e3
