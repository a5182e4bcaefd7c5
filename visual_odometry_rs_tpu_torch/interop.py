"""State carried between the JAX package and the port, as numpy arrays.

The JAX package's ``Intrinsics``, ``Pose``, ``LevelObs`` and
``KeyframeData`` are NamedTuples whose fields the port's types share by
name.  These functions take any object with those fields whose leaves numpy
can read (call ``np.asarray`` on the JAX arrays first) and build the port's
tensors on ``device``, or turn the port's state back into numpy.  No JAX is
imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Intrinsics
from .math.pose import Pose
from .models.tracker import KeyframeData, LevelObs
from .utils.types import to_numpy

_FLOAT_FIELDS = ("xs", "ys", "idepth", "tmpl_vals", "jacobians")


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def intrinsics_from_numpy(k, device="cpu") -> Intrinsics:
    return Intrinsics(*(_f32(getattr(k, f), device) for f in Intrinsics._fields))


def pose_from_numpy(p, device="cpu") -> Pose:
    return Pose(_f32(p.q, device), _f32(p.t, device))


def level_from_numpy(obs, device="cpu") -> LevelObs:
    return LevelObs(
        intrinsics=intrinsics_from_numpy(obs.intrinsics, device),
        template=torch.as_tensor(np.array(obs.template, np.uint8), device=device),
        valid=torch.as_tensor(np.array(obs.valid, bool), device=device),
        **{f: _f32(getattr(obs, f), device) for f in _FLOAT_FIELDS},
    )


def keyframe_from_numpy(kf, device="cpu") -> KeyframeData:
    return KeyframeData(levels=tuple(level_from_numpy(obs, device) for obs in kf.levels))


def pose_to_numpy(p: Pose) -> Pose:
    """The port's pose as a Pose of numpy arrays (q wxyz, t)."""
    return Pose(to_numpy(p.q), to_numpy(p.t))


def level_to_numpy(obs: LevelObs) -> LevelObs:
    return LevelObs(
        intrinsics=Intrinsics(*(to_numpy(v) for v in obs.intrinsics)),
        **{f: to_numpy(getattr(obs, f)) for f in LevelObs._fields if f != "intrinsics"},
    )


def keyframe_to_numpy(kf: KeyframeData) -> KeyframeData:
    return KeyframeData(levels=tuple(level_to_numpy(obs) for obs in kf.levels))

