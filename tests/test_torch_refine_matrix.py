"""The port's mirror of the accuracy matrix's refine rows (``REFINE_CORE``
of ``tests/test_accuracy_matrix.py``): the tracked and the window-refined
ATE of the ``c2f`` and ``dsofix`` selectors on ``tools/accuracy_matrix``'s
scene (6 frames at 160x120, rendered by the port's ``dataset/synthetic.py``),
tracked by the port's ``Tracker`` and refined by its ``SlidingWindow``
(a window of 3, 8 LM iterations), on the CPU.

The bounds are the JAX test's: the refined ATE below the tracked one +
0.005 and below 0.01.  Beside them, both ATEs within 1.5x of a live JAX
``run_combo`` on the same scene (measured on the CPU, port against JAX:
c2f tracked 1.4300e-3 against 1.4301e-3, refined 2.2339e-4 against
2.2335e-4; dsofix tracked 1.3989e-3 against 1.3988e-3, refined 2.6588e-4
against 2.6595e-4).  A JAX row takes about 50 s, 40 of it the window's
compiles (on several threads: about 120 s of CPU), so the module fixture
runs the two in two processes at once while the port runs here.  (One
process that loads the second row's window programs from a compilation
cache costs half the CPU but took 98 s in a full run.)
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from visual_odometry_rs_tpu_torch.dataset import synthetic
from visual_odometry_rs_tpu_torch.eval import ate
from visual_odometry_rs_tpu_torch.math import pose as pose_mod
from visual_odometry_rs_tpu_torch.models import sliding_window
from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
REFINE_CORE = ["c2f_l2_nobr_refine", "dsofix_l2_nobr_refine"]
JAX_FACTOR = 1.5

_JAX_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tools!r})
import jax
jax.config.update("jax_platforms", "cpu")
import accuracy_matrix
overrides, refine = accuracy_matrix.COMBOS[{combo!r}]
tracked, refined = accuracy_matrix.run_combo(accuracy_matrix._scene(), overrides, refine)
print(json.dumps({{"tracked": tracked, "refined": refined}}))
"""


def _scene():
    """``tools/accuracy_matrix._scene()`` rendered by the port."""
    return synthetic.generate_sequence(
        nb_frames=6, height=120, width=160, seed=0, twist_per_frame=[0.012, 0.004, 0.0, 0.002, 0.0, 0.001],
    )


def _overrides(combo):
    """``tools/accuracy_matrix.COMBOS``'s tracker overrides of the two rows."""
    sel, rob, br, ref = combo.split("_")
    assert (rob, br, ref) == ("l2", "nobr", "refine")
    return {"c2f": {}, "dsofix": {"candidate_selector": "dso_fixed", "dso_threshold_coef_a": 0.2}}[sel]


def _port_combo(seq, overrides, nb_levels=3, cap=1024):
    """The port's ``run_combo(seq, overrides, refine=True)``: (tracked ATE, refined ATE)."""
    h, w = seq.grays[0].shape
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=nb_levels, candidate_cap=cap, **overrides)
    trk = tracker_mod.init_tracker(config, seq.intrinsics, 0.0, seq.depths[0], 0.0, seq.grays[0], device="cpu")
    est = [pose_mod.identity()]
    for f in range(1, len(seq.grays)):
        trk.track(float(f), seq.depths[f], float(f), seq.grays[f])
        est.append(trk.current_pose)
    sw = sliding_window.SlidingWindow(config, seq.intrinsics, window_size=3, max_iterations=8, device="cpu")
    refined = list(est)
    sw.start(seq.depths[0], seq.grays[0], est[0])
    for f in range(1, len(seq.grays)):
        ids, poses = sw.add_frame(seq.depths[f], seq.grays[f], est[f])
        for fid, p in zip(ids, poses):
            refined[fid] = p
    return ate.ate_rmse(est, seq.poses), ate.ate_rmse(refined, seq.poses)


@pytest.fixture(scope="module")
def runs():
    """Each row by the port here and, meanwhile, by the JAX package in a
    process of its own."""
    procs = {
        combo: subprocess.Popen(
            [sys.executable, "-c", _JAX_RUN.format(repo=str(REPO), tools=str(REPO / "tools"), combo=combo)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for combo in REFINE_CORE
    }
    try:
        seq = _scene()
        port = {combo: _port_combo(seq, _overrides(combo)) for combo in REFINE_CORE}
        jax_runs = {}
        for combo, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            jax_runs[combo] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return port, jax_runs


@pytest.mark.parametrize("combo", REFINE_CORE)
def test_refined_ate_within_floor(runs, combo):
    tracked, refined = runs[0][combo]
    assert refined < tracked + 0.005, (combo, tracked, refined)
    assert refined < 0.01, (combo, refined)


@pytest.mark.parametrize("combo", REFINE_CORE)
def test_ates_within_jax_run(runs, combo):
    tracked, refined = runs[0][combo]
    ref = runs[1][combo]
    assert tracked <= JAX_FACTOR * ref["tracked"], (combo, tracked, ref)
    assert refined <= JAX_FACTOR * ref["refined"], (combo, refined, ref)
