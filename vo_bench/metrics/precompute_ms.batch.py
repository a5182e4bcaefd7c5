"""Host milliseconds of a clip's keyframe precomputes (the program's
``vors.precompute`` spans on check frames, summed): the median over the
traced clips."""

import spans


def read(record):
    return spans.median(spans.ms(g, "vors.precompute") for g in spans.groups(record))
