"""Trajectory-file parsing (reference ``examples/dataset_tum-read-trajectory.rs``).

The port of ``examples/dataset_tum_read_trajectory.py``; without a file it
parses an inline sample.  Host only: ``--cpu`` is accepted and changes nothing.

    python -m visual_odometry_rs_tpu_torch.examples.dataset_tum_read_trajectory [trajectory.txt]
"""

from __future__ import annotations

from ..dataset import tum_rgbd
from ._common import parser

SAMPLE = """# ground truth trajectory
1305031102.1758 1.3405 0.6266 1.6575 0.6574 0.6126 -0.2949 -0.3248
1305031102.2758 1.3303 0.6256 1.6464 0.6579 0.6161 -0.2932 -0.3189
"""


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("trajectory", nargs="?", help="a TUM trajectory file (default: an inline sample)")
    args = p.parse_args(argv)
    if args.trajectory:
        with open(args.trajectory) as f:
            content = f.read()
    else:
        content = SAMPLE
    frames = tum_rgbd.parse_trajectory(content)
    print(f"parsed {len(frames)} frames; first entries:")
    for fr in frames[:5]:
        print(" ", fr.to_string())
    return frames


if __name__ == "__main__":
    main()
