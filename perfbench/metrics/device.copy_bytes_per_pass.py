"""Bytes copied between host and device a pass: the program's
``device.h2d_bytes`` and ``device.d2h_bytes`` counters (counted at its
copy sites onto the card) over the traced window's passes."""
from perfbench import span_reader


def read(ctx):
    return span_reader.counter_per_pass(ctx, "device.h2d_bytes",
                                        "device.d2h_bytes")
