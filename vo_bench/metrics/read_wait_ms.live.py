"""Host milliseconds a steady frame waits on the device (the program's
``vors.read.*`` spans, summed): the median over the traced frames that kept
their keyframe."""

import spans


def read(record):
    return spans.median(spans.ms(g, prefix="vors.read.") for g in spans.frames(record, switched=0))
