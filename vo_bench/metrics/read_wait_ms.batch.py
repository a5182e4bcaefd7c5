"""Host milliseconds a clip waits on the device (the program's
``vors.read.*`` spans inside the clip's traced span, summed: the check
frames' switch masks and the clip's one read of its outputs): the median
over the traced clips."""

import spans


def read(record):
    return spans.median(spans.ms(g, prefix="vors.read.") for g in spans.groups(record))
