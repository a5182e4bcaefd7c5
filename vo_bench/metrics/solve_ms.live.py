"""Host milliseconds of a steady frame's solve (the program's ``vors.solve``
span: the pyramid, the warm start and the six level launches): the median
over the traced frames that kept their keyframe."""

import spans


def read(record):
    return spans.median(spans.ms(g, "vors.solve") for g in spans.frames(record, switched=0))
