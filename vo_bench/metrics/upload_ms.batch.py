"""Host milliseconds of a clip's upload (the program's ``vors.upload`` span:
the clip's depth maps and images to the device): the median over the
traced clips."""

import spans


def read(record):
    return spans.median(spans.ms(g, "vors.upload") for g in spans.groups(record))
