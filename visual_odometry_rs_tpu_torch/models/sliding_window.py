"""A DSO-style sliding keyframe window with frame marginalization, in
PyTorch.

The port of ``visual_odometry_rs_tpu/models/sliding_window.py`` on top of
the windowed photometric BA (``models.photometric_ba``):

- a window of up to W frames anchored at a keyframe, which changes on the
  tracker's mean-optical-flow criterion (inverse_compositional.rs:221-224);
- every incoming frame runs a pose-only solve at a coarse pyramid level,
  then the full-resolution staged solve;
- a frame that leaves a full window is marginalized: the information
  increment it carried becomes a Gaussian pose prior on the frames that
  stay (``_marginalize_oldest``);
- on a keyframe switch the window re-anchors on the newest frame and the
  prior is transported by the adjoint congruence (``switch_transfer=True``),
  or the window resets (``switch_transfer=False``).

``SlidingWindow`` refines one sequence; ``BatchedSlidingWindow`` advances B
sequences in lockstep, each with its own prior, members and keyframe, with
one batched solve a step.  Both hold their state on their device (the GPU
unless the caller names another) and share the lane-axis helpers below, so
a one-lane window is the batched code at B = 1.  A step reads the device
once per LM iteration (the solves' stop flags) and once more for the
refined poses and the flow criterion, in one transfer; the eigenvalue clamp
of a marginalization runs on the device.  ``BatchedSlidingWindow(mesh=)``
spreads the lanes of its solves over the devices of a mesh axis.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float, depth_tensor, image_tensor, resolve_device
from . import photometric_ba
from . import tracker as tracker_mod


def marginalize_frame(S: torch.Tensor, j: int, eps: float = 1e-6) -> torch.Tensor:
    """Schur-marginalize frame ``j`` out of a (…, F, P, F, P) camera system.

    Returns the (…, F-1, 6, F-1, 6) pose-block information over the other
    frames, in their order; with P = 8 the departing frame's brightness is
    marginalized too and the others' brightness rows are dropped (the prior
    carries poses only)."""
    F, P = S.shape[-4], S.shape[-3]
    keep = torch.tensor([i for i in range(F) if i != j], device=S.device)
    S_kk = S.index_select(-4, keep).index_select(-2, keep)
    S_kj = S.index_select(-4, keep)[..., :, :, j, :]  # (…, F-1, P, P)
    S_jj = S[..., j, :, j, :] + eps * torch.eye(P, dtype=Float, device=S.device)
    S_jj_inv = torch.linalg.inv_ex(S_jj)[0]  # no host read of the status
    # symmetric system: S[j, :, g, :] = S[g, :, j, :]^T
    left = S_kj @ S_jj_inv[..., None, :, :]  # (…, F-1, P, P): S_kj S_jj^-1
    lead = S.shape[:-4]
    n = (F - 1) * P
    rows = left.reshape(*lead, n, P)
    cols = S_kj.reshape(*lead, n, P)
    fill = (rows @ cols.transpose(-1, -2)).reshape(*lead, F - 1, P, F - 1, P)
    return (S_kk - fill)[..., :6, :, :6]


def _psd_clamp(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize (…, n, n) and clamp its eigenvalues at 0."""
    M = 0.5 * (M + M.transpose(-1, -2))
    eigval, eigvec = torch.linalg.eigh(M)
    return (eigvec * torch.clamp_min(eigval, 0.0)[..., None, :]) @ eigvec.transpose(-1, -2)


def _transport(H: torch.Tensor, Ad: torch.Tensor) -> torch.Tensor:
    """``H'[f,x,g,y] = Σ_ab Ad[a,x] H[f,a,g,b] Ad[b,y]`` per lane: H (B, F,
    6, F, 6), Ad (B, 6, 6)."""
    blocks = H.permute(0, 1, 3, 2, 4)  # (B, F, F, 6, 6)
    Ad5 = Ad[:, None, None]
    out = Ad5.transpose(-1, -2) @ blocks @ Ad5
    return out.permute(0, 1, 3, 2, 4)


def _mean_flow(coarse, model: Pose) -> torch.Tensor:
    """The tracker's keyframe criterion per lane: the mean |Δu| + |Δv| of
    the valid coarsest-level candidates under ``model`` (B,), padding left
    out as in the JAX package's jitted code; NaN without a valid one."""
    k = photometric_ba._lane_k(coarse.intrinsics)
    k = Intrinsics(*(v[..., 0] for v in k))  # (B|1, 1)
    u, v = camera_mod.warp(Pose(model.q[:, None], model.t[:, None]), coarse.xs, coarse.ys, coarse.idepth, k)
    d = torch.abs(coarse.xs - u) + torch.abs(coarse.ys - v)
    return torch.sum(torch.where(coarse.valid, d, torch.zeros_like(d)), dim=-1) / torch.sum(
        coarse.valid.to(Float), dim=-1)


def _stack(models: List[Pose]) -> Pose:
    """Per-slot poses (B, …) → Pose (B, F, …)."""
    return Pose(torch.stack([m.q for m in models], dim=1), torch.stack([m.t for m in models], dim=1))


def _lane(p: Pose) -> Pose:
    """A pose with a lane axis of 1."""
    return Pose(p.q[None], p.t[None])


def _slots(p: Pose) -> List[Pose]:
    return [Pose(q, t) for q, t in zip(p.q.unbind(1), p.t.unbind(1))]


class _Lanes:
    """The state and steps shared by both windows, with a leading lane axis
    on every tensor: the keyframe's levels, its camera-to-world pose and
    refined inverse depths, the members' images (full and coarse) and
    keyframe->frame models, one slot each, the prior and its anchors."""

    def __init__(self, config, intrinsics, window_size, marginalize, max_iterations, idepth_prior_weight,
                 energy_tol, robust_delta, brightness, coarse_level, device):
        if window_size < 2:
            raise ValueError("window_size must be >= 2")
        self.config = config
        self.device = resolve_device(device)
        self.intrinsics = intrinsics.to(self.device)
        self.window_size = window_size
        self.marginalize = marginalize
        self._solve_opts = dict(
            max_iterations=max_iterations, idepth_prior_weight=idepth_prior_weight, energy_tol=energy_tol,
            robust_delta=robust_delta, brightness=brightness,
        )
        self._idepth_prior_weight = idepth_prior_weight
        self._robust_delta = robust_delta
        self._brightness = brightness
        # coarse-to-fine: a pose-only solve at this level widens the basin
        # before the full-resolution solve; 0 disables
        self.coarse_level = min(coarse_level, config.nb_levels - 1)
        self.kf_levels = None
        self.kf_c2w: Optional[Pose] = None
        self.idepth = None
        self.images: List[torch.Tensor] = []
        self.images_coarse: List[torch.Tensor] = []
        self.models: List[Pose] = []
        self.prior_H = None
        self.prior_anchors: Optional[Pose] = None
        self._next_id = 0
        self.mesh = None  # lanes of the solves over a mesh axis's devices
        self.mesh_axis = "data"

    # -- device inputs -------------------------------------------------------

    def _pyramid(self, gray):
        return pyramid_ops.mean_pyramid(self.config.nb_levels, image_tensor(gray, self.device))

    def _precompute(self, depth, pyr):
        mask = None
        if self.config.candidate_selector == "dso":  # its host recursion, a lane at a time
            mask = torch.stack([tracker_mod.dso_mask(self.config, img) for img in pyr[0]])
        return tracker_mod.precompute_keyframe(
            self.config, self.intrinsics, depth_tensor(depth, self.device), pyr, finest_mask=mask
        )

    # -- lane-axis steps -----------------------------------------------------

    def _window(self, models, images, level=0):
        """The window of the given slots; ``win.idepth`` is the keyframe's
        sensor depths (the prior's anchor), refined depths enter as the
        solve's ``idepth_init``."""
        return photometric_ba.window_from_tracking(
            self.config, self.intrinsics, self.kf_levels, torch.stack(images, dim=1), _stack(models), level=level
        )

    def _padded_prior(self, F: int):
        """The prior over F slots: zero blocks, and anchors at the current
        models for the slots it does not cover yet (they multiply zero H)."""
        B, k = self.prior_H.shape[0], self.prior_H.shape[1]
        if k == F:
            return self.prior_H, self.prior_anchors
        Hp = self.prior_H.new_zeros((B, F, 6, F, 6))
        Hp[:, :k, :, :k, :] = self.prior_H
        tail = _stack(self.models[k:F])
        return Hp, Pose(torch.cat([self.prior_anchors.q, tail.q], dim=1),
                        torch.cat([self.prior_anchors.t, tail.t], dim=1))

    def _pad_prior_to(self, F: int) -> None:
        if self.prior_H.shape[1] != F:
            self.prior_H, self.prior_anchors = self._padded_prior(F)

    def _reset_prior(self) -> None:
        m = _stack(self.models)
        F = m.q.shape[1]
        self.prior_H = torch.zeros((m.q.shape[0], F, 6, F, 6), dtype=Float, device=self.device)
        self.prior_anchors = m

    def _drop_slot_1(self) -> List[int]:
        keep = [0] + list(range(2, len(self.models)))
        self.images = [self.images[i] for i in keep]
        self.images_coarse = [self.images_coarse[i] for i in keep]
        self.models = [self.models[i] for i in keep]
        return keep

    def _marginalize_oldest(self) -> List[int]:
        """Fold slot 1 (the oldest frame after the keyframe) into the prior,
        and drop it.  The prior keeps only the information increment:

            H_new = Schur_marg_1(photo(all) + prior) - photo(kept only)

        because the kept frames' photometric terms are built again by every
        later solve; folding the whole marginal in would count them twice
        on every marginalization.  The difference is symmetrized and its
        eigenvalues clamped at 0."""
        F = len(self.models)
        prior = self._padded_prior(F)
        lm0 = torch.zeros((self.idepth.shape[0],), dtype=Float, device=self.device)
        opts = dict(robust_delta=self._robust_delta, ab=None, brightness=self._brightness)
        win = self._window(self.models, self.images)
        S_with = photometric_ba._camera_system_b(
            win, win.poses, self.idepth, lm0, float(self._idepth_prior_weight), pose_prior=prior, **opts,
        )[0]
        H_marg = marginalize_frame(S_with, 1)
        keep = [0] + list(range(2, F))
        win_kept = self._window([self.models[i] for i in keep], [self.images[i] for i in keep])
        S_without = photometric_ba._camera_system_b(
            win_kept, win_kept.poses, self.idepth, lm0, float(self._idepth_prior_weight), pose_prior=None, **opts,
        )[0]
        B, n = S_with.shape[0], (F - 1) * 6
        M = _psd_clamp((H_marg - S_without[:, :, :6, :, :6]).reshape(B, n, n))
        self._drop_slot_1()
        self.prior_H = M.reshape(B, F - 1, 6, F - 1, 6)
        self.prior_anchors = _stack(self.models)
        return keep

    def _solve(self, level: int, idepth_init):
        Hp, anchors = self._padded_prior(len(self.models))
        opts = dict(self._solve_opts)
        if level > 0:
            # pose-only at the sensor depths; the prior is in full-resolution
            # photometric units, scaled down for the ~4^level fewer pairs
            images, Hp, opts["refine_depth"] = self.images_coarse, Hp * 4.0 ** -level, False
        else:
            images = self.images
        win = self._window(self.models, images, level=level)
        return photometric_ba.solve_window_batched(win, self.mesh, self.mesh_axis, pose_prior=(Hp, anchors),
                                                   idepth_init=idepth_init, **opts)

    def _refine(self) -> None:
        """The coarse pose-only solve, then the full-resolution staged solve."""
        if self.coarse_level > 0:
            self.models = _slots(self._solve(self.coarse_level, None).poses)
        res = self._solve(0, self.idepth)
        self.idepth = res.idepth
        self.models = _slots(res.poses)

    def _refined_and_flow(self):
        """The members' camera-to-world poses (B, F) on the device and, in one
        transfer, on the host with each lane's flow criterion."""
        m = _stack(self.models)
        kf = Pose(self.kf_c2w.q[:, None], self.kf_c2w.t[:, None])
        refined = pose_mod.compose(kf, pose_mod.inverse(m))
        flow = _mean_flow(self.kf_levels[-1], self.models[-1])
        B, F = m.q.shape[:2]
        host = torch.cat([refined.q.reshape(B, -1), refined.t.reshape(B, -1), flow[:, None]], dim=1).cpu()
        return refined, Pose(host[:, : 4 * F].reshape(B, F, 4), host[:, 4 * F: 7 * F].reshape(B, F, 3)), host[:, -1]

    def _switch_transfer(self, switch: torch.Tensor) -> List[int]:
        """Re-anchor the lanes where ``switch`` (B,) holds on their newest
        frame: models re-expressed as ``m'_f = m_f ∘ m_new⁻¹``, the prior
        transported by ``H' = Adᵀ H Ad``, ``Ad = Adj(m_new⁻¹)`` (an exact
        change of variables), the slots reordered newest first and the new
        gauge frame's blocks conditioned out.  Returns the slot order."""
        F = len(self.models)
        Hp, anchors = self._padded_prior(F)
        j = F - 1
        order = [j] + [i for i in range(F) if i != j]
        m = _stack(self.models)
        inv_new = pose_mod.inverse(self.models[j])
        nm = pose_mod.compose(m, Pose(inv_new.q[:, None], inv_new.t[:, None]))
        ident = pose_mod.identity(self.device)
        is_j = (torch.arange(F, device=self.device) == j)[None, :, None]
        nm = Pose(torch.where(is_j, ident.q, nm.q), torch.where(is_j, ident.t, nm.t))  # exact gauge
        Ht = _transport(Hp, se3.adjoint(inv_new))
        idx = torch.tensor(order, device=self.device)
        Ht = Ht.index_select(1, idx).index_select(3, idx)
        Ht[:, 0] = 0.0  # condition out the new gauge frame
        Ht[:, :, :, 0] = 0.0
        nm = Pose(nm.q.index_select(1, idx), nm.t.index_select(1, idx))
        sw = switch[:, None]
        new_models = Pose(photometric_ba._where(sw, nm.q, m.q), photometric_ba._where(sw, nm.t, m.t))
        self.models = _slots(new_models)
        self.prior_H = photometric_ba._where(switch, Ht, Hp)
        # switching lanes re-anchor at their transferred models; the others
        # keep their marginalization-time anchors
        self.prior_anchors = Pose(photometric_ba._where(sw, new_models.q, anchors.q),
                                  photometric_ba._where(sw, new_models.t, anchors.t))
        self.images = [photometric_ba._where(switch, self.images[o], img) for o, img in zip(order, self.images)]
        self.images_coarse = [photometric_ba._where(switch, self.images_coarse[o], img)
                              for o, img in zip(order, self.images_coarse)]
        return order

    def _new_epoch(self, switch: torch.Tensor, kf, c2w: Pose) -> None:
        """The switching lanes' fresh depth epoch: the new keyframe's levels,
        sensor depths and camera-to-world pose."""
        def sel(new, old):
            return photometric_ba._where(switch, new, old)

        self.kf_levels = tracker_mod.map_keyframe(sel, tracker_mod.KeyframeData(kf.levels),
                                                  tracker_mod.KeyframeData(self.kf_levels)).levels
        self.idepth = sel(kf.levels[0].idepth, self.idepth)
        self.kf_c2w = Pose(sel(c2w.q, self.kf_c2w.q), sel(c2w.t, self.kf_c2w.t))

    def _append(self, pyr, model: Pose) -> None:
        """Add the new frame's slot, from its pyramid."""
        self.images.append(pyr[0].to(Float))
        self.images_coarse.append(pyr[self.coarse_level].to(Float) if self.coarse_level > 0 else self.images[-1])
        self.models.append(model)


class SlidingWindow(_Lanes):
    """Streaming DSO-style sliding-window refiner of one sequence.

    Usage::

        sw = SlidingWindow(config, intrinsics, window_size=6)
        sw.start(depth0, gray0, c2w0)
        for each frame: ids, poses = sw.add_frame(depth, gray, c2w_init)

    ``ids``/``poses``: the refreshed camera-to-world estimates (host
    tensors) of the frames in the window, keyframe first.  ``c2w_init`` is
    the tracker's (or any) initialization of the new frame.  The JAX
    package's options and defaults, without ``interp_method``;
    ``device`` is where the state lives and the solves run (the GPU unless
    named).  The state lives in the attributes the JAX package's window has
    (``kf_levels``, ``kf_c2w``, ``idepth``, ``images``, ``images_coarse``,
    ``models``, ``frame_ids``, ``prior_H``, ``prior_anchors``,
    ``keyframe_switches``), its tensors with a lane axis of 1;
    ``interop.window_state_to_numpy`` gives them in the JAX package's
    layout."""

    def __init__(
        self,
        config: tracker_mod.TrackerConfig,
        intrinsics: Intrinsics,
        window_size: int = 6,
        *,
        marginalize: bool = True,
        max_iterations: int = 15,
        idepth_prior_weight: float = 1e4,
        energy_tol: float = 0.01,
        robust_delta: float = 0.0,
        brightness: bool = False,
        coarse_level: int = 1,
        switch_transfer: bool = True,
        collect_clouds: bool = False,
        device="cuda",
    ):
        super().__init__(config, intrinsics, window_size, marginalize, max_iterations, idepth_prior_weight,
                         energy_tol, robust_delta, brightness, coarse_level, device)
        self.switch_transfer = switch_transfer
        self.frame_ids: List[int] = []
        self.keyframe_switches = 0
        # each retiring keyframe's candidates with their refined depths
        self.collect_clouds = collect_clouds
        self.retired_clouds: List = []

    def _lane_inputs(self, depth, gray):
        """One frame's depth and pyramid with a lane axis of 1."""
        return depth_tensor(depth, self.device)[None], self._pyramid(image_tensor(gray, self.device)[None])

    def _set_keyframe(self, depth, pyr, c2w: Pose, frame_id: int) -> None:
        kf = self._precompute(depth, pyr)
        self.kf_levels = kf.levels
        self.kf_c2w = c2w
        self.idepth = kf.levels[0].idepth
        self.images = [pyr[0].to(Float)]
        self.images_coarse = [pyr[self.coarse_level].to(Float)]
        self.models = [_lane(pose_mod.identity(self.device))]
        self.frame_ids = [frame_id]
        self._reset_prior()

    def keyframe_cloud(self) -> Tuple[np.ndarray, np.ndarray]:
        """World-frame (M, 3) points and (M,) u8 intensities of the current
        keyframe's candidates at their refined inverse depths, through the
        refined keyframe pose ``kf_c2w ∘ models[0]⁻¹`` (slot 0 can move in
        the joint solve).  One transfer."""
        if self.kf_levels is None:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.uint8)
        obs = self.kf_levels[0]
        kf_pose = pose_mod.compose(self.kf_c2w, pose_mod.inverse(self.models[0]))
        idepth = self.idepth[0]
        ok = obs.valid[0] & (idepth > 0.0)
        d = torch.where(ok, idepth, torch.ones_like(idepth))
        cam = camera_mod.back_project(obs.intrinsics, torch.stack([obs.xs[0], obs.ys[0]], dim=-1),
                                      torch.ones_like(d) / d)
        world = pose_mod.apply(Pose(kf_pose.q[0], kf_pose.t[0]), cam)
        host = torch.cat([world, obs.tmpl_vals[0][:, None], ok[:, None].to(Float)], dim=1).cpu().numpy()
        mask = host[:, 4] > 0
        return (np.ascontiguousarray(host[mask, :3], np.float32),
                np.clip(host[mask, 3], 0, 255).astype(np.uint8))

    def start(self, depth, gray, c2w: Pose | None = None) -> int:
        """Start with the first keyframe; returns its frame id."""
        c2w = pose_mod.identity(self.device) if c2w is None else c2w.to(self.device)
        fid = self._next_id
        self._next_id += 1
        self._set_keyframe(*self._lane_inputs(depth, gray), _lane(c2w), fid)
        return fid

    def add_frame(self, depth, gray, c2w_init: Pose) -> Tuple[List[int], List[Pose]]:
        """Add a frame, refine the window, maybe switch keyframe.  Returns
        ``(frame_ids, refined_c2w)`` for every frame in the window, keyframe
        first; the poses are host tensors."""
        fid = self._next_id
        self._next_id += 1
        # keyframe->frame model init: model = c2w_frame^-1 ∘ c2w_kf
        model = pose_mod.compose(pose_mod.inverse(_lane(c2w_init.to(self.device))), self.kf_c2w)
        if len(self.models) == self.window_size:
            if self.marginalize:
                keep = self._marginalize_oldest()
            else:
                keep = self._drop_slot_1()
                self._reset_prior()
            self.frame_ids = [self.frame_ids[i] for i in keep]
        depth, pyr = self._lane_inputs(depth, gray)
        self._append(pyr, model)
        self.frame_ids.append(fid)
        self._refine()
        refined_dev, refined, flow = self._refined_and_flow()
        ids = list(self.frame_ids)
        out = [Pose(q, t) for q, t in zip(refined.q[0], refined.t[0])]
        # keyframe switch on the tracker's flow criterion (newest frame)
        if float(flow[0]) >= self.config.flow_threshold:
            if self.collect_clouds:
                self.retired_clouds.append(self.keyframe_cloud())
            new_c2w = Pose(refined_dev.q[:, -1], refined_dev.t[:, -1])
            if self.switch_transfer:
                self._switch(depth, pyr, new_c2w)
            else:
                self._set_keyframe(depth, pyr, new_c2w, fid)
            self.keyframe_switches += 1
        return ids, out

    def _switch(self, depth, pyr, refined_c2w: Pose) -> None:
        """The keyframe switch with the prior transferred (the JAX package's
        ``_switch_keyframe_transfer``); the old keyframe stays as a regular
        frame, the first to be marginalized when the window fills, and the
        depths start a fresh epoch from the new keyframe's sensor data."""
        kf = self._precompute(depth, pyr)
        order = self._switch_transfer(torch.ones((1,), dtype=torch.bool, device=self.device))
        self.kf_levels, self.kf_c2w, self.idepth = kf.levels, refined_c2w, kf.levels[0].idepth
        self.frame_ids = [self.frame_ids[i] for i in order]


class BatchedSlidingWindow(_Lanes):
    """B sequences refined in lockstep, each with its own prior, members and
    keyframe epoch, with one batched coarse and one batched full solve a
    step, one batched marginalization when the windows are full and, on a
    step where any lane's flow criterion fires, one batched keyframe
    precompute selected per lane.

    ``switch_transfer=True`` only: a reset would leave one lane with one
    frame while the others keep F.  Lanes share ``window_size``, the
    tracker configuration and the intrinsics.  The state carries a leading
    (B,) axis: ``frame_ids`` (F, B) and ``keyframe_switches`` (B,) are
    numpy, the rest tensors on the device.  ``mesh`` spreads the lanes of
    the coarse and the full solve, the bulk of a step, over the devices of
    ``mesh[mesh_axis]`` (``photometric_ba.solve_window_batched(mesh=)``;
    B a multiple of their number); the state, the marginalization and the
    keyframe precompute stay on ``device``."""

    def __init__(
        self,
        config: tracker_mod.TrackerConfig,
        intrinsics: Intrinsics,
        window_size: int = 6,
        *,
        marginalize: bool = True,
        max_iterations: int = 15,
        idepth_prior_weight: float = 1e4,
        energy_tol: float = 0.01,
        robust_delta: float = 0.0,
        brightness: bool = False,
        coarse_level: int = 1,
        switch_transfer: bool = True,
        mesh=None,
        mesh_axis: str = "data",
        device="cuda",
    ):
        if not switch_transfer:
            raise ValueError(
                "BatchedSlidingWindow requires switch_transfer=True: a reset switch would give lanes "
                "different window lengths; use SlidingWindow for the reset policy"
            )
        super().__init__(config, intrinsics, window_size, marginalize, max_iterations, idepth_prior_weight,
                         energy_tol, robust_delta, brightness, coarse_level, device)
        self.switch_transfer = True
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.frame_ids: Optional[np.ndarray] = None
        self.keyframe_switches: Optional[np.ndarray] = None
        self.batch: Optional[int] = None

    def start(self, depths, grays, c2w: Pose | None = None) -> int:
        """Start all B lanes with their first keyframes: ``depths``/``grays``
        (B, H, W), ``c2w`` a Pose (B,) (identity by default).  Returns the
        shared frame id."""
        pyr = self._pyramid(grays)
        B = pyr[0].shape[0]
        self.batch = B
        ident = pose_mod.identity(self.device)
        if c2w is None:
            c2w = Pose(ident.q.expand(B, 4).clone(), ident.t.expand(B, 3).clone())
        fid = self._next_id
        self._next_id += 1
        kf = self._precompute(depths, pyr)
        self.kf_levels = kf.levels
        self.kf_c2w = c2w.to(self.device)
        self.idepth = kf.levels[0].idepth
        self.images = [pyr[0].to(Float)]
        self.images_coarse = [pyr[self.coarse_level].to(Float)]
        self.models = [Pose(ident.q.expand(B, 4).clone(), ident.t.expand(B, 3).clone())]
        self.frame_ids = np.full((1, B), fid, np.int64)
        self._reset_prior()
        self.keyframe_switches = np.zeros((B,), np.int64)
        return fid

    def add_frame(self, depths, grays, c2w_init: Pose):
        """Advance every lane by one frame; returns ``(frame_ids (F, B),
        refined Pose (B, F))``: the camera-to-world estimates (host tensors)
        of the frames in each lane's window, in slot order (after a lane's
        switch newest first, as ``frame_ids[:, lane]``)."""
        B = self.batch
        fid = self._next_id
        self._next_id += 1
        c2w_init = c2w_init.to(self.device)
        model = pose_mod.compose(pose_mod.inverse(c2w_init), self.kf_c2w)
        if len(self.models) == self.window_size:
            keep = self._marginalize_oldest() if self.marginalize else self._drop_slot_1()
            if not self.marginalize:
                self._reset_prior()
            self.frame_ids = self.frame_ids[keep]
        pyr = self._pyramid(grays)
        self._append(pyr, model)
        self.frame_ids = np.concatenate([self.frame_ids, np.full((1, B), fid, np.int64)])
        self._pad_prior_to(len(self.models))
        self._refine()
        refined_dev, refined, flows = self._refined_and_flow()
        ids = self.frame_ids.copy()
        switch = (flows >= self.config.flow_threshold).numpy()
        if switch.any():
            F = len(self.models)
            switch_dev = torch.from_numpy(switch).to(self.device)
            order = self._switch_transfer(switch_dev)
            # the fresh depth epoch: all lanes precompute, the switching ones keep it
            kf = self._precompute(depths, pyr)
            self._new_epoch(switch_dev, kf, Pose(refined_dev.q[:, F - 1], refined_dev.t[:, F - 1]))
            self.frame_ids = np.where(switch[None, :], self.frame_ids[order], self.frame_ids)
            self.keyframe_switches += switch.astype(np.int64)
        return ids, refined
