"""Share of its roofline that the solver kernel ``lm_solve_level`` reaches in
the traced clips: its least time (``roofline.py``) over its device time."""

import roofline


def read(record):
    return roofline.share_pct(record, "lm_solve_level_kernel")
