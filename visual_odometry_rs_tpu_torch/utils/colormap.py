"""Viridis colormap (reference ``src/misc/colormap.rs``).

The port of ``visual_odometry_rs_tpu/utils/colormap.py``.  The reference
embeds the 256-entry viridis table as literals (colormap.rs:22-281); the JAX
package takes it from matplotlib as ``round(255 * rgb)``.  Those u8 values
are written here as literals (``rrggbb`` hex, 12 entries a line), so the
port needs no matplotlib.  Host numpy.
"""

from __future__ import annotations

import numpy as np

_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725"
)
_TABLE = np.frombuffer(bytes.fromhex("".join(_HEX)), np.uint8).reshape(256, 3)


def viridis_table() -> np.ndarray:
    """(256, 3) uint8 viridis lookup table."""
    return _TABLE.copy()


def viridis_u8(values: np.ndarray) -> np.ndarray:
    """Map u8 intensities (…,) → RGB u8 (…, 3) through viridis (colormap.rs:8-19)."""
    return _TABLE[np.asarray(values, np.uint8)]


def viridis_float(values: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """Map floats in [vmin, vmax] → RGB u8 (…, 3) through viridis."""
    v = np.asarray(values, np.float64)
    scale = max(vmax - vmin, 1e-12)
    idx = np.clip((v - vmin) / scale * 255.0, 0, 255).astype(np.uint8)
    return _TABLE[idx]
