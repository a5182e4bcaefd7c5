"""Association-file parsing (reference ``examples/dataset_tum-read-associations.rs``).

The port of ``examples/dataset_tum_read_associations.py``; without a file it
parses an inline sample.  Host only: ``--cpu`` is accepted and changes nothing.

    python -m visual_odometry_rs_tpu_torch.examples.dataset_tum_read_associations [associations.txt]
"""

from __future__ import annotations

from ..dataset import tum_rgbd
from ._common import parser

SAMPLE = """# depth_ts depth_file color_ts color_file
1305031102.160407 depth/1305031102.160407.png 1305031102.175304 rgb/1305031102.175304.png
1305031102.194330 depth/1305031102.194330.png 1305031102.211214 rgb/1305031102.211214.png
"""


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("associations", nargs="?", help="a TUM associations file (default: an inline sample)")
    args = p.parse_args(argv)
    if args.associations:
        with open(args.associations) as f:
            content = f.read()
    else:
        content = SAMPLE
    assocs = tum_rgbd.parse_associations(content)
    print(f"parsed {len(assocs)} associations; first entries:")
    for a in assocs[:5]:
        print(f"  depth {a.depth_timestamp} {a.depth_file_path}  color {a.color_timestamp} {a.color_file_path}")
    return assocs


if __name__ == "__main__":
    main()
