"""DSO candidate-point selection, in PyTorch.

The port of ``visual_odometry_rs_tpu/core/candidates/dso.py`` (reference
``src/core/candidates/dso.rs``, the picker of "Direct Sparse Odometry",
Engel et al., PAMI 2018):

1. 32x32-region median gradients (dso.rs:307-325),
2. 3x3-smoothed quadratic thresholds ``a (mean3x3(median) + b)^2``
   (dso.rs:284-303),
3. per-block max-gradient picking over ``nb_levels`` block scales with a
   decaying threshold factor (dso.rs:154-276),
4. recursive block-size adaptation toward a target point count with bounds
   (0.8, 4.0) and random thinning above ratio 1.1 (dso.rs:98-147).

Plain torch: these run once per keyframe switch, never per frame, and no
TPU kernel backs them.  Every stage takes a leading lane axis ((B, H, W)
gradients, as the batched keyframe precompute gives them) except the host
recursion ``select``.  Integer values stay exact: medians, block maxima and
picks are integers, the 3x3 sums of medians are integers below 2^24 in f32,
and the threshold keeps the JAX package's f32 order ``(a t) t``.

Random thinning.  The JAX package draws
``jax.random.randint(PRNGKey(seed), shape, 0, 256)`` (seed 0).  The port
draws the same bits: ``seeded_plane`` computes JAX's Threefry-2x32 counter
generator in numpy on the host (the partitionable layout, JAX's default
since 0.5), once per shape, seed and device.  ``select_fixed_block`` and
``select`` still take the plane as an optional ``random_plane`` argument.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ...utils.types import Float

_INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class RegionConfig:
    """(dso.rs:37-42, defaults :72-75: "(2.0,3) in dso and (1.0,3) in ldso")."""

    size: int = 32
    threshold_coef_a: float = 1.0
    threshold_coef_b: int = 3


@dataclass(frozen=True)
class BlockConfig:
    """(dso.rs:45-53, defaults :78-82)."""

    base_size: int = 4
    nb_levels: int = 3
    threshold_factor: float = 0.5


@dataclass(frozen=True)
class RecursiveConfig:
    """(dso.rs:58-69, defaults :85-90)."""

    nb_iterations_left: int = 1
    low_thresh: float = 0.8
    high_thresh: float = 4.0
    random_thresh: float = 1.1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as an f32 scalar tensor on ``like``'s device: the
    JAX package's weakly typed constants round to f32 the same way."""
    return torch.tensor(x, dtype=Float, device=like.device)


def _tiles(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """(…, H, W) → (…, nr, nc, size * size): ``size`` x ``size`` tiles in
    row-major order inside a tile, the right/bottom edge padded with ``fill``."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    nr, nc = _ceil_div(h, size), _ceil_div(w, size)
    padded = torch.full((*lead, nr * size, nc * size), fill, dtype=torch.int32, device=x.device)
    padded[..., :h, :w] = x
    tiles = padded.reshape(*lead, nr, size, nc, size).transpose(-3, -2)
    return tiles.reshape(*lead, nr, nc, size * size)


def region_median_gradients(gradients: torch.Tensor, size: int) -> torch.Tensor:
    """Median gradient of each size x size region, right/bottom regions
    possibly smaller (dso.rs:307-325).  The median is ``sorted[len // 2]``,
    the UPPER median (``torch.median`` would take the lower one)."""
    h, w = gradients.shape[-2:]
    tiles = torch.sort(_tiles(gradients, size, _INT32_MAX), dim=-1).values
    nr, nc = tiles.shape[-3:-1]
    device = gradients.device
    rh = torch.clamp(h - torch.arange(nr, device=device) * size, max=size)
    rw = torch.clamp(w - torch.arange(nc, device=device) * size, max=size)
    index = (rh[:, None] * rw[None, :]) // 2
    return torch.gather(tiles, -1, index.expand(tiles.shape[:-1])[..., None])[..., 0]


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 sum with zero padding (a SAME convolution with ones), in a fixed
    order; exact for the integer-valued inputs it gets."""
    h, w = x.shape[-2:]
    padded = torch.zeros((*x.shape[:-2], h + 2, w + 2), dtype=x.dtype, device=x.device)
    padded[..., 1 : h + 1, 1 : w + 1] = x
    out = torch.zeros_like(x)
    for di in range(3):
        for dj in range(3):
            out = out + padded[..., di : di + h, dj : dj + w]
    return out


def region_thresholds(median_gradients: torch.Tensor, coef_a: float, coef_b: int) -> torch.Tensor:
    """``a (mean3x3(median) + b)^2`` truncated to an integer, with
    edge-aware 3x3 means: the 3x3 sum of the medians over the 3x3 count of
    regions (dso.rs:284-303).  The product is ``(a t) t`` in f32, the
    reference's left-associated order: ``a t^2`` can differ by one ulp."""
    med = median_gradients.to(Float)
    mean = _box3(med) / _box3(torch.ones_like(med))
    tmp = mean + _f32(float(coef_b), med)
    thresh = (_f32(coef_a, med) * tmp) * tmp
    return torch.trunc(thresh).to(torch.int32)


def _block_max(gradients: torch.Tensor, block_size: int):
    """(max value, row, column) of each block, edge blocks smaller
    (dso.rs:193-222).  Ties pick the first value in row-major order."""
    tiles = _tiles(gradients, block_size, -1)
    idx = torch.argmax(tiles, dim=-1)  # the first maximum
    val = torch.gather(tiles, -1, idx[..., None])[..., 0]
    nr, nc = tiles.shape[-3:-1]
    device = gradients.device
    bi = torch.arange(nr, device=device)[:, None]
    bj = torch.arange(nc, device=device)[None, :]
    return val, bi * block_size + idx // block_size, bj * block_size + idx % block_size


def _gmax(m1, m2):
    """``if m1.val < m2.val then m2 else m1`` (dso.rs:225-239)."""
    take2 = m1[0] < m2[0]
    return tuple(torch.where(take2, b, a) for a, b in zip(m1, m2))


def _halve_max(m):
    """2x2 halving of (val, i, j) block-max maps with the reference's
    tie-preference chain ``g_max(a, g_max(b, g_max(c, d)))``."""
    h2, w2 = m[0].shape[-2] // 2, m[0].shape[-1] // 2
    if h2 == 0 or w2 == 0:
        return None

    def corner(di, dj):
        return tuple(x[..., di : 2 * h2 : 2, dj : 2 * w2 : 2] for x in m)

    a, b, c, d = corner(0, 0), corner(1, 0), corner(0, 1), corner(1, 1)
    return _gmax(a, _gmax(b, _gmax(c, d)))


def _pick_all(
    gradients: torch.Tensor,
    thresholds: torch.Tensor,
    block_size: int,
    nb_levels: int,
    threshold_factor: float,
    region_size: int,
):
    """Pick candidates at all block levels (dso.rs:156-276).

    Returns (total picked count, (…,) int32; picked-level u8 map, (…, H, W)).
    No host read: picks are scattered to flat indices, unpicked blocks to a
    dump slot."""
    h, w = gradients.shape[-2:]
    lead = gradients.shape[:-2]
    device = gradients.device
    maxg = [_block_max(gradients, block_size)]
    for _ in range(1, nb_levels):
        nxt = _halve_max(maxg[-1])
        if nxt is None:
            break
        maxg.append(nxt)

    candidates = torch.zeros((*lead, h * w + 1), dtype=torch.uint8, device=device)
    flat_thresholds = thresholds.reshape(*lead, -1).to(Float)
    region_cols = thresholds.shape[-1]
    mask = torch.ones(maxg[0][0].shape[-2:], dtype=torch.bool, device=device)
    coef = 1.0
    total = torch.zeros(lead, dtype=torch.int32, device=device)
    for level, (val, pi, pj) in enumerate(maxg):
        mh, mw = mask.shape[-2:]
        eh, ew = mh // 2 * 2, mw // 2 * 2
        # blocks outside the even crop are ignored at this level (dso.rs:260-261)
        in_crop = torch.zeros((mh, mw), dtype=torch.bool, device=device)
        in_crop[:eh, :ew] = True
        region = (pi // region_size) * region_cols + pj // region_size
        region_thresh = torch.gather(flat_thresholds, -1, region.expand(val.shape).reshape(*lead, -1))
        meets = val.to(Float) >= _f32(coef, val) * region_thresh.reshape(val.shape)
        picked = mask & in_crop & meets
        total = total + picked.sum(dim=(-2, -1), dtype=torch.int32)
        # the level number at the picked argmax pixels (one per block)
        flat = torch.where(picked, pi * w + pj, torch.full_like(pi, h * w))
        candidates.scatter_(-1, flat.reshape(*lead, -1), level + 1)
        # next-level mask: all 4 children must be unpicked and masked in
        if level + 1 < len(maxg):
            keep = (mask & ~picked)[..., :eh, :ew]
            mask = keep[..., 0::2, 0::2] & keep[..., 1::2, 0::2] & keep[..., 0::2, 1::2] & keep[..., 1::2, 1::2]
            coef *= threshold_factor
    return total, candidates[..., : h * w].reshape(*lead, h, w)


def _select_once(gradients, block_size, nb_levels, threshold_factor, region_size, coef_a, coef_b):
    med = region_median_gradients(gradients, region_size)
    thresh = region_thresholds(med, coef_a, coef_b)
    return _pick_all(gradients, thresh, block_size, nb_levels, threshold_factor, region_size)


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 block cipher of ``jax.random`` on uint32
    arrays: five groups of four rounds, the rotations alternating between
    the two sets, a key injection after every group."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def jax_randint_256(shape: Tuple[int, ...], seed: int = 0) -> np.ndarray:
    """``jax.random.randint(PRNGKey(seed), shape, 0, 256, int32)`` in numpy.

    ``PRNGKey(seed)`` is the key (0, seed); ``randint`` splits it in two, and
    for a span of 256 only the second key's bits count (the first's
    multiplier, (2^16 mod 256)^2 mod 256, is 0).  The bits of a key are
    Threefry of the flat index as a 64-bit counter (high word, low word),
    the two output words xor-ed."""
    with np.errstate(over="ignore"):
        keys = _threefry2x32((0, seed), np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
        second = (keys[0][1], keys[1][1])
        idx = np.arange(math.prod(shape), dtype=np.uint64)
        a, b = _threefry2x32(second, (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32))
    return ((a ^ b) % np.uint32(256)).astype(np.int32).reshape(shape)


def jax_uniform(shape: Tuple[int, ...], seed: int, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), shape, float32, minval, maxval)``
    in numpy: the 32 bits of an element are Threefry of its flat index as a
    64-bit counter, the two words xor-ed (no split); the top 23 bits make a
    float in [1, 2), minus 1, scaled to [minval, maxval)."""
    with np.errstate(over="ignore"):
        idx = np.arange(math.prod(shape), dtype=np.uint64)
        a, b = _threefry2x32((0, seed), (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32))
    unit = (((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, unit * (hi - lo) + lo).reshape(shape)


@lru_cache(maxsize=8)
def _seeded_plane(shape: Tuple[int, ...], seed: int, device: str) -> torch.Tensor:
    return torch.from_numpy(jax_randint_256(shape, seed)).to(device)


def seeded_plane(shape, seed: int = 0, device="cpu") -> torch.Tensor:
    """The thinning draws, uniform in [0, 256), int32 of ``shape``: the JAX
    package's ``randint(PRNGKey(seed), shape, 0, 256)``, bit for bit."""
    return _seeded_plane(tuple(shape), seed, str(torch.device(device)))


def select_fixed_block(
    gradients: torch.Tensor,
    nb_target: int,
    *,
    block_size: int = 4,
    region_config: RegionConfig = RegionConfig(),
    block_config: BlockConfig = BlockConfig(),
    recursive_config: RecursiveConfig = RecursiveConfig(),
    random_plane: torch.Tensor | None = None,
    seed: int = 0,
) -> torch.Tensor:
    """Recursion-free DSO selection at a fixed block size (the JAX
    package's ``dso_fixed``): one pick pass, then the reference's random
    thinning (keep where ``rnd <= int(255 / ratio)``, dso.rs:140-143) only
    when ``random_thresh < ratio`` and the ratio lies inside the recursion's
    (low, high) bounds.  No host read; a leading lane axis thins every lane
    with one (H, W) plane, as the JAX package's vmap does with one key."""
    rc, rec = region_config, recursive_config
    thresholds = region_thresholds(
        region_median_gradients(gradients, rc.size), rc.threshold_coef_a, rc.threshold_coef_b
    )
    total, picked = _pick_all(
        gradients, thresholds, block_size, block_config.nb_levels, block_config.threshold_factor, rc.size
    )
    mask = picked > 0
    totalf = total.to(Float)
    ratio = totalf / torch.full_like(totalf, float(nb_target))  # a true division, as the JAX package's
    if random_plane is None:
        random_plane = seeded_plane(gradients.shape[-2:], seed, gradients.device)
    cutoff = torch.floor(torch.full_like(ratio, 255.0) / torch.clamp(ratio, min=1e-9)).to(torch.int32)
    thin = (ratio > rec.random_thresh) & (ratio >= rec.low_thresh) & (ratio <= rec.high_thresh)
    thinned = mask & (random_plane <= cutoff[..., None, None])
    return torch.where(thin[..., None, None], thinned, mask)


def select(
    gradients: torch.Tensor,
    nb_target: int,
    *,
    region_config: RegionConfig = RegionConfig(),
    block_config: BlockConfig = BlockConfig(),
    recursive_config: RecursiveConfig = RecursiveConfig(),
    random_plane: torch.Tensor | None = None,
    seed: int = 0,
) -> torch.Tensor:
    """DSO candidate selection toward ``nb_target`` points (dso.rs:98-147),
    for one (H, W) gradient image.  The block-size recursion is a host
    decision: each pass reads its pick count on the host.  Returns a bool
    mask."""
    block, rec, rc = block_config, recursive_config, region_config
    while True:
        total, picked = _select_once(
            gradients, block.base_size, block.nb_levels, block.threshold_factor,
            rc.size, rc.threshold_coef_a, rc.threshold_coef_b,
        )
        ratio = int(total) / nb_target
        # nb_candidates ≈ K / (block_size + 1)^2 ⇒ rescale (dso.rs:117-126)
        target_size = max(1, round(math.sqrt(ratio) * (block.base_size + 1) - 1.0))
        if ratio < rec.low_thresh or ratio > rec.high_thresh:
            if target_size != block.base_size and rec.nb_iterations_left > 0:
                block = BlockConfig(target_size, block.nb_levels, block.threshold_factor)
                rec = RecursiveConfig(
                    rec.nb_iterations_left - 1, rec.low_thresh, rec.high_thresh, rec.random_thresh
                )
                continue
            return picked > 0
        if ratio > rec.random_thresh:
            # random thinning: keep with probability ~ 1/ratio (dso.rs:140-143)
            if random_plane is None:
                random_plane = seeded_plane(gradients.shape, seed, gradients.device)
            return (picked > 0) & (random_plane <= int(255.0 / ratio))
        return picked > 0
