"""Host-device copies a pass: the program's ``device.h2d_copies`` and
``device.d2h_copies`` counters (counted at its copy sites onto the card)
over the traced window's passes."""
from perfbench import span_reader


def read(ctx):
    return span_reader.counter_per_pass(ctx, "device.h2d_copies",
                                        "device.d2h_copies")
