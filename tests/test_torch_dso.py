"""The port's DSO selectors (``core/candidates/dso.py``) and gradient norms
against the JAX package and the scalar oracle ``tests/oracle/dso_oracle.py``.

Every comparison is EQUAL: the stages are integer arithmetic, the 3x3 sums
of medians are exact in f32, and the threshold keeps the JAX package's f32
order.  The random thinning plane is the JAX package's
``jax.random.randint(PRNGKey(seed), shape, 0, 256)``: the port draws the same
bits (``seeded_plane``, Threefry-2x32 in numpy), which the tests below hold
bit-equal, and the masks equal with and without the plane passed in.  Oracle
inputs are the tie-free gradients of
``tests/test_oracle_dso.py`` (coefficient a = 1/4096 undoes their scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import dso_oracle
from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.core.candidates import dso as jdso
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.ops import gradient as jgrad
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.core.candidates import dso as tdso
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import gradient as tgrad
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

H, W = 120, 160


@pytest.fixture(scope="module")
def scene():
    return tsyn.generate_sequence(nb_frames=2, height=H, width=W, seed=0)


@pytest.fixture(scope="module")
def norms(scene):
    """The gradient norm of frame 0: (JAX as numpy, port)."""
    return np.asarray(jgrad.norm_direct(jnp.asarray(scene.grays[0]))), tgrad.norm_direct(
        torch.from_numpy(scene.grays[0])
    )


def _plane(shape):
    return np.array(jax.random.randint(jax.random.PRNGKey(0), shape, 0, 256, jnp.int32))


_jax_block_max = jax.jit(jdso._block_max, static_argnums=1)
_jax_pick_all = jax.jit(jdso._pick_all, static_argnums=(2, 3, 4, 5))


def test_gradient_norms_match():
    img = np.random.default_rng(3).integers(0, 256, (37, 53)).astype(np.uint8)
    ref_sq = np.asarray(jgrad.squared_norm_direct(jnp.asarray(img)))
    out_sq = tgrad.squared_norm_direct(torch.from_numpy(img))
    np.testing.assert_array_equal(out_sq.numpy(), ref_sq.astype(np.int64))
    np.testing.assert_array_equal(tgrad.norm_direct(torch.from_numpy(img)).numpy(),
                                  np.asarray(jgrad.norm_direct(jnp.asarray(img))).astype(np.int64))


@pytest.mark.parametrize("coef_a", [1.0, 0.2, 0.37])
def test_region_stages_match(norms, coef_a):
    jg, tg = norms
    med_j = np.asarray(jdso.region_median_gradients(jnp.asarray(jg), 32))
    med_t = tdso.region_median_gradients(tg, 32)
    np.testing.assert_array_equal(med_t.numpy(), med_j)
    np.testing.assert_array_equal(tdso.region_thresholds(med_t, coef_a, 3).numpy(),
                                  np.asarray(jdso.region_thresholds(jnp.asarray(med_j), coef_a, 3)))


@pytest.mark.parametrize("block_size", [3, 4, 6])
def test_block_maxima_and_picks_match(norms, block_size):
    jg, tg = norms
    for a, b in zip(tdso._block_max(tg, block_size), _jax_block_max(jnp.asarray(jg), block_size)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    thr = tdso.region_thresholds(tdso.region_median_gradients(tg, 32), 0.2, 3)
    total, picked = tdso._pick_all(tg, thr, block_size, 3, 0.5, 32)
    ref_total, ref_picked = _jax_pick_all(jnp.asarray(jg), jnp.asarray(thr.numpy()), block_size, 3, 0.5, 32)
    assert int(total) == int(ref_total) > 0
    np.testing.assert_array_equal(picked.numpy(), np.asarray(ref_picked))


# (coef_a, target): 150 at a = 0.2 thins (ratio about 1.4), 2000 does not
@pytest.mark.parametrize("coef_a,target", [(0.2, 150), (0.2, 2000), (0.37, 60), (1.0, 300)])
def test_select_fixed_block_matches(norms, coef_a, target):
    jg, tg = norms
    ref = np.asarray(jdso.select_fixed_block(jnp.asarray(jg), target,
                                             region_config=jdso.RegionConfig(threshold_coef_a=coef_a)))
    out = tdso.select_fixed_block(tg, target, region_config=tdso.RegionConfig(threshold_coef_a=coef_a),
                                  random_plane=torch.from_numpy(_plane(jg.shape)))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("coef_a,target", [(0.2, 150), (0.2, 2000), (0.2, 40), (0.37, 300)])
def test_select_matches(norms, coef_a, target):
    """The host recursion: 2000 and 40 change the block size, 150 thins."""
    jg, tg = norms
    ref = np.asarray(jdso.select(jnp.asarray(jg), target, region_config=jdso.RegionConfig(threshold_coef_a=coef_a)))
    out = tdso.select(tg, target, region_config=tdso.RegionConfig(threshold_coef_a=coef_a),
                      random_plane=torch.from_numpy(_plane(jg.shape)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_select_fixed_block_lane_axis(scene):
    grads = tgrad.norm_direct(torch.from_numpy(scene.grays))  # (2, H, W)
    plane = torch.from_numpy(_plane((H, W)))
    cfg = tdso.RegionConfig(threshold_coef_a=0.2)
    both = tdso.select_fixed_block(grads, 150, region_config=cfg, random_plane=plane)
    for b in range(2):
        assert torch.equal(both[b], tdso.select_fixed_block(grads[b], 150, region_config=cfg, random_plane=plane))
    # without a plane: JAX's plane of seed 0, the same for every call
    assert torch.equal(tdso.select_fixed_block(grads, 150, region_config=cfg),
                       tdso.select_fixed_block(grads, 150, region_config=cfg, seed=0))


@pytest.mark.parametrize("shape", [(480, 640), (3, 120, 160), (48, 64)])
@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_plane_is_jax_randint(shape, seed):
    """The port's plane bit-equal to ``randint(PRNGKey(seed), shape, 0, 256)``."""
    ref = np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 256, jnp.int32))
    out = tdso.seeded_plane(shape, seed)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


# the thinning cases of the tests above: ratio about 1.4 and 2.7 at a = 0.2
@pytest.mark.parametrize("target", [150, 80])
def test_selectors_match_without_a_plane(norms, target):
    """``select_fixed_block`` and ``select`` equal to JAX's with no plane
    passed: the port draws JAX's plane itself."""
    jg, tg = norms
    cfg_j, cfg_t = jdso.RegionConfig(threshold_coef_a=0.2), tdso.RegionConfig(threshold_coef_a=0.2)
    fixed = tdso.select_fixed_block(tg, target, region_config=cfg_t)
    ref = np.asarray(jdso.select_fixed_block(jnp.asarray(jg), target, region_config=cfg_j))
    assert fixed.sum() < (tdso.select_fixed_block(tg, 10**6, region_config=cfg_t)).sum()  # it thinned
    np.testing.assert_array_equal(fixed.numpy(), ref)
    ref = np.asarray(jdso.select(jnp.asarray(jg), target, region_config=cfg_j))
    np.testing.assert_array_equal(tdso.select(tg, target, region_config=cfg_t).numpy(), ref)
    # a seed other than 0 is PRNGKey(seed)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jdso.select_fixed_block(jnp.asarray(jg), target, region_config=cfg_j, key=key))
    np.testing.assert_array_equal(tdso.select_fixed_block(tg, target, region_config=cfg_t, seed=7).numpy(), ref)


def test_precompute_keyframe_dso_thinned_matches(scene):
    """The ``dso_fixed`` and ``dso`` keyframes of both packages at a target
    that thins, no plane passed: the same candidates at level 0."""
    kw = dict(height=H, width=W, nb_levels=3, candidate_cap=1024, dso_threshold_coef_a=0.2, dso_target=150)
    intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in scene.intrinsics))
    depth, gray = scene.depths[0], scene.grays[0]
    for selector in ("dso_fixed", "dso"):
        jcfg = jtracker.TrackerConfig(**kw, candidate_selector=selector)
        jpyramid = jpyr.mean_pyramid(3, jnp.asarray(gray))
        mask = None
        if selector == "dso":  # as the JAX host Tracker builds it
            mask = jdso.select(jgrad.norm_direct(jpyramid[0]), kw["dso_target"],
                               region_config=jdso.RegionConfig(threshold_coef_a=0.2))
        ref = jtracker.precompute_keyframe(jcfg, intr, jnp.asarray(depth), jpyramid, finest_mask=mask)
        tcfg = ttracker.TrackerConfig(**kw, candidate_selector=selector)
        tpyramid = tpyr.mean_pyramid(3, torch.from_numpy(gray))
        tmask = ttracker.dso_mask(tcfg, tpyramid[0]) if selector == "dso" else None
        out = ttracker.precompute_keyframe(tcfg, scene.intrinsics, torch.from_numpy(depth.astype(np.int32)),
                                           tpyramid, finest_mask=tmask)
        r, o = ref.levels[0], interop.level_to_numpy(out.levels[0])
        assert 0 < o.valid.sum() < 400, selector
        for f in ("xs", "ys", "valid"):
            np.testing.assert_array_equal(getattr(o, f), np.asarray(getattr(r, f)), err_msg=f"{selector} {f}")


def test_flow_leaves_padding_out_as_the_jitted_jax_tracker(scene):
    """A thinned ``dso_fixed`` keyframe has padding at the coarsest level,
    which warps to NaN.  The JAX package's jitted ``track_frame`` (what its
    trackers run) leaves it out of the mean flow, as XLA compiles
    ``sum(dflow * valid)`` into a select; the port's flow equals it
    (``rtol=1e-4``, the solver's flow tolerance), finite."""
    kw = dict(height=H, width=W, nb_levels=3, candidate_cap=1024, candidate_selector="dso_fixed",
              dso_threshold_coef_a=0.2, dso_target=150)
    intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in scene.intrinsics))
    jcfg, tcfg = jtracker.TrackerConfig(**kw, interp_method="gather"), ttracker.TrackerConfig(**kw)
    jkf = jax.jit(lambda d, p: jtracker.precompute_keyframe(jcfg, intr, d, p))(
        jnp.asarray(scene.depths[0]), jpyr.mean_pyramid(3, jnp.asarray(scene.grays[0])))
    ref = jax.jit(lambda kf, p: jtracker.track_frame(jcfg, kf, p, jtracker.pose_mod.identity()))(
        jkf, jpyr.mean_pyramid(3, jnp.asarray(scene.grays[1])))
    tkf = ttracker.precompute_keyframe(tcfg, scene.intrinsics, torch.from_numpy(scene.depths[0].astype(np.int32)),
                                       tpyr.mean_pyramid(3, torch.from_numpy(scene.grays[0])))
    out = ttracker.track_frame(tcfg, tkf, tpyr.mean_pyramid(3, torch.from_numpy(scene.grays[1])),
                               ttracker.pose_mod.identity())
    assert not bool(tkf.levels[-1].valid.all())  # padding at the coarsest level
    assert np.isfinite(float(ref.flow)) and float(ref.flow) > 0.0
    np.testing.assert_allclose(float(out.flow), float(ref.flow), rtol=1e-4)


def test_precompute_keyframe_dso_fixed_matches(scene):
    """The ``dso_fixed`` keyframe of both packages (no thinning at this
    target): the same candidates at every level."""
    kw = dict(height=H, width=W, nb_levels=3, candidate_cap=1024, candidate_selector="dso_fixed",
              dso_threshold_coef_a=0.2)
    intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in scene.intrinsics))
    ref = jax.jit(lambda d, p: jtracker.precompute_keyframe(jtracker.TrackerConfig(**kw), intr, d, p))(
        jnp.asarray(scene.depths[0]), jpyr.mean_pyramid(3, jnp.asarray(scene.grays[0]))
    )
    out = ttracker.precompute_keyframe(
        ttracker.TrackerConfig(**kw), scene.intrinsics, torch.from_numpy(scene.depths[0].astype(np.int32)),
        tpyr.mean_pyramid(3, torch.from_numpy(scene.grays[0])),
    )
    for r, o in zip(ref.levels, out.levels):
        o = interop.level_to_numpy(o)
        assert 0 < o.valid.sum()
        for f in ("xs", "ys", "valid"):
            np.testing.assert_array_equal(getattr(o, f), np.asarray(getattr(r, f)), err_msg=f)
    with pytest.raises(ValueError, match="dso"):
        ttracker.precompute_keyframe(
            ttracker.TrackerConfig(**{**kw, "candidate_selector": "dso"}), scene.intrinsics,
            torch.from_numpy(scene.depths[0].astype(np.int32)), tpyr.mean_pyramid(3, torch.from_numpy(scene.grays[0])),
        )


# --- the scalar oracle (tests/oracle/dso_oracle.py) --------------------------

SCALE = 4096
REGION = dict(size=32, coef_a=1.0 / SCALE, coef_b=3)


def _unique_gradients(h, w, seed):
    """``tests/test_oracle_dso.py::_unique_gradients``, with the port's
    centered gradients (the same integers)."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = 128 + 8 * np.sin(ii / 9.0) + 7 * np.cos(jj / 11.0)
    for _ in range(max(20, h * w // 400)):
        pi, pj = rng.integers(1, h - 7), rng.integers(1, w - 7)
        img[pi : pi + 6, pj : pj + 6] += rng.choice([-80, 80])
    img = np.clip(img, 0, 255).astype(np.uint8)
    gx, gy = (x.numpy().astype(np.int64) for x in tgrad.centered_f32(torch.from_numpy(img)))
    g = np.clip(gx**2 + gy**2, 0, 455)
    return (g * SCALE + (ii % 64) * 64 + (jj % 64)).astype(np.int64)


def _port_region():
    return tdso.RegionConfig(size=REGION["size"], threshold_coef_a=REGION["coef_a"],
                             threshold_coef_b=REGION["coef_b"])


@pytest.mark.parametrize("shape", [(96, 128), (94, 121)])
def test_oracle_stages_match(shape):
    g = _unique_gradients(*shape, seed=shape[0])
    tg = torch.from_numpy(g.astype(np.int32))
    med = dso_oracle.region_median_gradients(g, 32)
    np.testing.assert_array_equal(tdso.region_median_gradients(tg, 32).numpy(), med)
    thr = dso_oracle.region_thresholds(med, REGION["coef_a"], REGION["coef_b"])
    np.testing.assert_array_equal(
        tdso.region_thresholds(torch.from_numpy(med.astype(np.int32)), REGION["coef_a"], REGION["coef_b"]).numpy(),
        thr,
    )
    for block_size in (4, 6):
        ref = dso_oracle.init_max_gradients(g, block_size)
        for k, out in enumerate(tdso._block_max(tg, block_size)):
            np.testing.assert_array_equal(out.numpy(), np.array([[c[k] for c in row] for row in ref]))


@pytest.mark.parametrize("factor", [1, 8, -4])
def test_oracle_composed_selection_matches(factor):
    """Ratio about 1 (no recursion), above 4 (a larger block) and below 0.8
    (a smaller block), at targets whose oracle run does not thin (the
    oracle flags thinning instead of drawing)."""
    g = _unique_gradients(96, 128, seed=11 if factor == 1 else 7 if factor > 1 else 13)
    thr = dso_oracle.region_thresholds(dso_oracle.region_median_gradients(g, 32), REGION["coef_a"], REGION["coef_b"])
    count = sum(dso_oracle.pick_all_block_candidates(dso_oracle.BlockConfig(), 32, thr, g)[0])
    target = count if factor == 1 else max(1, count // factor) if factor > 1 else count * -factor
    res = dso_oracle.select(g, dso_oracle.RegionConfig(**REGION), dso_oracle.BlockConfig(),
                            dso_oracle.RecursiveConfig(), target)
    assert not res.needs_random_thinning
    assert (res.final_block_size == 4) == (factor == 1)
    out = tdso.select(torch.from_numpy(g.astype(np.int32)), target, region_config=_port_region())
    np.testing.assert_array_equal(out.numpy(), res.mask)
