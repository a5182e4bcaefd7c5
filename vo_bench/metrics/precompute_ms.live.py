"""Host milliseconds of the keyframe precompute (the program's
``vors.precompute`` span: the depth upload, the precompute and the
bucketing read): the median over the traced frames that switched."""

import spans


def read(record):
    return spans.median(spans.ms(g, "vors.precompute") for g in spans.frames(record, switched=1))
