"""Synthetic RGB-D traffic: closed-loop camera paths over a textured plane,
rendered on the device from the seed.

The scene is a slanted plane ``z = z0 + a x + b y`` (metres, world frame)
whose texture is a sum of sinusoids of the plane coordinates, mapped to
grey levels by a fixed range, so a point's brightness never changes with
the view.  Depth is u16 at ``depth_scale`` a metre (TUM's 5000).

Every lane follows one Lissajous path in translation and in rotation (a
rotation vector), with integer frequencies over ``loop_frames`` frames, so
frame ``loop_frames`` is frame 0 again and a sequence repeats without a
jump.  The path's shape, frequencies and phases come from the traffic file,
and its amplitudes are scaled so that the mean motion a frame is the
traffic's speed over its rate.  The seed draws each lane's texture phases
and the frame of the loop it starts at (``draw_lanes``): every seed gets
the same motion and the same kind of texture, in another order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Lane(NamedTuple):
    waves: np.ndarray  # (n, 4): frequency x, frequency y (cycles a metre), phase, amplitude
    offset: int  # the loop's frame that is this lane's frame 0


class Sequences(NamedTuple):
    grays: np.ndarray  # (F, B, H, W) u8, on the host
    depths: np.ndarray  # (F, B, H, W) u16, on the host
    rotations: np.ndarray  # (F, B, 3, 3) float64 camera-to-world
    translations: np.ndarray  # (F, B, 3)


def draw_lanes(traffic: dict, seed: int, nb_lanes: int):
    """Each lane's texture and starting frame.  The textures' spectra (wave
    frequencies and amplitudes) are fixed by the traffic's ``texture_seed``;
    the seed deals them to the lanes in its own order and draws the waves'
    phases and each lane's starting frame, so every seed tracks the same
    kind of texture along the same loop."""
    scene = traffic["scene"]
    n = int(scene["texture_waves"])
    f_lo, f_hi = scene["wave_cycles_per_m"]
    a_lo, a_hi = scene["wave_amplitude"]
    fixed = np.random.default_rng(int(scene["texture_seed"]))
    spectra = [np.stack([fixed.uniform(f_lo, f_hi, n), fixed.uniform(f_lo, f_hi, n), fixed.uniform(a_lo, a_hi, n)], 1)
               for _ in range(nb_lanes)]
    rng = np.random.default_rng(seed)
    lanes = []
    for b in rng.permutation(nb_lanes):
        fx, fy, amp = spectra[b].T
        waves = np.stack([fx, fy, rng.uniform(0.0, 2 * np.pi, n), amp], axis=1)
        lanes.append(Lane(waves, int(rng.integers(0, int(traffic["loop_frames"])))))
    return lanes


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation matrices (…, 3, 3) of rotation vectors (…, 3)."""
    th = np.linalg.norm(r, axis=-1)[..., None, None]
    safe = np.where(th > 1e-12, th, 1.0)
    k = r / safe[..., 0]
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    z = np.zeros_like(kx)
    hat = np.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], axis=-1).reshape(*r.shape[:-1], 3, 3)
    eye = np.broadcast_to(np.eye(3), hat.shape)
    return eye + np.sin(th) * hat + (1.0 - np.cos(th)) * (hat @ hat)


def _rotation_step(rot: np.ndarray) -> np.ndarray:
    """Angle between consecutive rotations of a closed loop (F, 3, 3)."""
    rel = np.einsum("fji,fjk->fik", rot, np.roll(rot, -1, axis=0))
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(cos)


def path(traffic: dict, lane: Lane):
    """Camera-to-world rotations (F, 3, 3) and translations (F, 3) of one
    lane's loop, from its starting frame."""
    motion, shape = traffic["motion"], traffic["path"]
    frames, rate = int(traffic["loop_frames"]), float(traffic["rate_hz"])
    tau = 2 * np.pi * (np.arange(frames)[:, None] + lane.offset) / frames

    def wave(freq, phase):
        return np.sin(np.asarray(freq)[None, :] * tau + np.asarray(phase)[None, :])

    trans = np.asarray(shape["translation_shape"]) * wave(shape["translation_freq"], shape["translation_phase"])
    step = np.linalg.norm(np.roll(trans, -1, axis=0) - trans, axis=1).mean()
    trans *= float(motion["translation_m_per_s"]) / rate / step
    rotvec = np.asarray(shape["rotation_shape"]) * wave(shape["rotation_freq"], shape["rotation_phase"])
    target = math.radians(float(motion["rotation_deg_per_s"])) / rate
    scale = 1.0
    for _ in range(8):  # the mean angle a frame is nearly linear in the scale
        scale *= target / _rotation_step(rodrigues(scale * rotvec)).mean()
    return rodrigues(scale * rotvec), trans


def render(k, height: int, width: int, rot: torch.Tensor, trans: torch.Tensor, waves: torch.Tensor,
           plane, texture_sigmas: float, depth_scale: float):
    """Grey (n, H, W) u8 and depth (n, H, W) int32 of the plane seen from
    camera-to-world poses ``rot`` (n, 3, 3) and ``trans`` (n, 3), with the
    texture ``waves`` (n, m, 4), all float64 on one device."""
    dev = rot.device
    cx, cy, fx, fy = (float(v) for v in k)
    jj = torch.arange(width, dtype=torch.float64, device=dev)
    ii = torch.arange(height, dtype=torch.float64, device=dev)
    d_cam = torch.stack(torch.broadcast_tensors(((jj - cx) / fx)[None, :], ((ii - cy) / fy)[:, None],
                                                torch.ones((1, 1), dtype=torch.float64, device=dev)), -1)
    d_world = torch.einsum("hwj,nij->nhwi", d_cam, rot)
    a, b, z0 = (float(v) for v in plane)
    normal = torch.tensor([-a, -b, 1.0], dtype=torch.float64, device=dev)
    lam = (z0 - trans @ normal)[:, None, None] / (d_world @ normal)  # camera-frame depth
    pts = trans[:, None, None, :] + lam[..., None] * d_world
    visible = (lam > 0.1) & (lam < 10.0)
    tex = torch.zeros_like(lam)
    for i in range(waves.shape[1]):
        fx_i, fy_i, ph, amp = (waves[:, i, j][:, None, None] for j in range(4))
        tex += amp * torch.sin(2 * math.pi * (fx_i * pts[..., 0] + fy_i * pts[..., 1]) + ph)
    spread = texture_sigmas * torch.sqrt(0.5 * (waves[:, :, 3] ** 2).sum(1))[:, None, None]
    gray = torch.floor(torch.clamp(127.5 + 127.5 * tex / spread, 0.0, 255.0))
    gray = torch.where(visible, gray, torch.zeros_like(gray)).to(torch.uint8)
    depth = torch.where(visible, torch.round(lam * depth_scale), torch.zeros_like(lam))
    return gray, torch.clamp(depth, 0.0, 65535.0).to(torch.int32)


def make_sequences(config: dict, traffic: dict, seed: int, device, chunk: int = 16) -> Sequences:
    """Every lane's loop rendered on ``device`` and copied to host arrays,
    (frame, lane) outermost, as a loader would hand them over."""
    nb_lanes, height, width = int(config["lanes"]), int(config["height"]), int(config["width"])
    lanes = draw_lanes(traffic, seed, nb_lanes)
    paths = [path(traffic, lane) for lane in lanes]
    frames = int(traffic["loop_frames"])
    rots = np.stack([p[0] for p in paths], axis=1)
    transl = np.stack([p[1] for p in paths], axis=1)
    grays = np.empty((frames, nb_lanes, height, width), np.uint8)
    depths = np.empty((frames, nb_lanes, height, width), np.uint16)
    flat_rot = torch.from_numpy(rots.reshape(-1, 3, 3)).to(device)
    flat_t = torch.from_numpy(transl.reshape(-1, 3)).to(device)
    waves = torch.from_numpy(np.stack([lane.waves for lane in lanes])).to(device)
    scene = traffic["scene"]
    n = frames * nb_lanes
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        lane_idx = torch.arange(s, e, device=device) % nb_lanes
        g, d = render(config["intrinsics"], height, width, flat_rot[s:e], flat_t[s:e], waves[lane_idx],
                      scene["plane"], float(scene["texture_sigmas"]), float(config["depth_scale"]))
        # values below 2^16 fit int16 bit for bit, which the host reads as u16
        d16 = torch.where(d > 32767, d - 65536, d).to(torch.int16)
        grays.reshape(n, height, width)[s:e] = g.cpu().numpy()
        depths.reshape(n, height, width)[s:e] = d16.cpu().numpy().view(np.uint16)
    return Sequences(grays, depths, rots, transl)
