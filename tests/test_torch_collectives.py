"""The port's collectives (``parallel/collectives.py``) on 4 gloo ranks,
against the JAX package's rings on a 4-device slice of the 8 virtual CPU
devices (the mirror of ``tests/test_collectives.py``).

The ranks are 4 processes that import torch and the port only
(``run_ranks``: one gloo group, a ``FileStore`` in the test's directory,
inputs and results through ``.npz`` files); the JAX references run in the
test process, once per module.  Tolerances:

- the three rings: **bit-equal** to JAX's (the same hops, the same
  summation order, f32 adds on both sides);
- ``psum``: bit-equal to the sum in rank order of the numpy inputs, the
  same bits on every rank;
- a leading dim that the axis size does not divide raises ``ValueError``,
  as JAX's does.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from visual_odometry_rs_tpu.parallel import collectives as jcoll
from visual_odometry_rs_tpu.parallel import mesh as jmesh
from visual_odometry_rs_tpu_torch.parallel import collectives as tcoll
from visual_odometry_rs_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

N = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the header of every rank program: argv = rank, world, directory
RANK_HEADER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from visual_odometry_rs_tpu_torch.parallel import collectives, mesh as mesh_mod
mesh_mod.init_distributed(init_method=f"file://{where}/store", world_size=world, rank=rank, device="cpu")
mesh = mesh_mod.make_mesh((world,), ("x",), devices=["cpu"], groups={"x": dist.group.WORLD})
inputs = dict(np.load(f"{where}/inputs.npz"))
out = {}
'''
RANK_FOOTER = r'''
np.savez(f"{where}/rank{rank}.npz", **out)
dist.barrier()  # no rank tears its connections down while another still uses them
dist.destroy_process_group()
'''


def run_ranks(program: str, inputs: dict, where, world: int = N, timeout: int = 240, meanwhile=None):
    """Run ``program`` (after ``RANK_HEADER``, before ``RANK_FOOTER``) on
    ``world`` gloo ranks, one process each, with ``inputs`` saved for them,
    and ``meanwhile()`` in this process while they run; returns each rank's
    ``out`` dict."""
    where = str(where)
    np.savez(os.path.join(where, "inputs.npz"), **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = RANK_HEADER + program + RANK_FOOTER
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), where], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True) for r in range(world)]
    failures = []
    try:
        if meanwhile is not None:
            meanwhile()
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failures.append(f"rank {r} exited {p.returncode}:\n{out}\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not failures, "\n".join(failures)
    return [dict(np.load(os.path.join(where, f"rank{r}.npz"))) for r in range(world)]


PROGRAM = r'''
x = torch.from_numpy(inputs["rs"][rank])
out["reduce_scatter"] = collectives.ring_reduce_scatter(x, mesh, "x").numpy()
out["all_gather"] = collectives.ring_all_gather(torch.from_numpy(inputs["ag"][rank]), mesh, "x").numpy()
out["all_reduce"] = collectives.ring_all_reduce(torch.from_numpy(inputs["ar"][rank]), mesh, "x").numpy()
m, c = collectives.psum((torch.from_numpy(inputs["ps"][rank]), torch.tensor([rank + 1], dtype=torch.int32)), mesh, "x")
out["psum"], out["psum_count"] = m.numpy(), c.numpy()
try:
    collectives.ring_reduce_scatter(torch.zeros(N_BAD, 3), mesh, "x")
    out["bad_raised"] = np.array(False)
except ValueError as e:
    out["bad_raised"] = np.array("not divisible" in str(e))
'''.replace("N_BAD", str(N * 2 + 1))


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {
        "rs": rng.normal(size=(N, N * 4, 3)).astype(np.float32),
        "ag": rng.normal(size=(N, 2, 5)).astype(np.float32),
        "ar": rng.normal(size=(N, N * 2, 6)).astype(np.float32),
        "ps": rng.normal(size=(N, 7, 2)).astype(np.float32),
    }
    ranks = run_ranks(PROGRAM, inputs, tmp_path_factory.mktemp("collectives"))
    mesh = jmesh.make_mesh((N,), ("x",), devices=jax.devices()[:N])
    spec = P("x", None, None)

    def rs(xl):
        return jcoll.ring_reduce_scatter(xl[0], "x", N)[None]

    def ag(xl):
        return jcoll.ring_all_gather(xl[0], "x", N)[None]

    def ar(xl):
        return jcoll.ring_all_reduce(xl[0], "x", N)[None]

    jax_out = {
        name: np.asarray(_shard_map(fn, mesh, (spec,), spec)(jnp.asarray(inputs[key])))
        for name, fn, key in (("reduce_scatter", rs, "rs"), ("all_gather", ag, "ag"), ("all_reduce", ar, "ar"))
    }
    return inputs, ranks, jax_out


@pytest.mark.parametrize("name", ["reduce_scatter", "all_gather", "all_reduce"])
def test_rings_bit_equal_to_jax(runs, name):
    inputs, ranks, jax_out = runs
    for r in range(N):
        np.testing.assert_array_equal(ranks[r][name], jax_out[name][r])
    if name == "reduce_scatter":  # and they are the sum: rank i holds chunk i
        want = inputs["rs"].sum(axis=0).reshape(N, 4, 3)
        np.testing.assert_allclose(np.stack([ranks[r][name] for r in range(N)]), want, rtol=1e-5, atol=1e-5)
    if name == "all_gather":
        for r in range(N):
            np.testing.assert_array_equal(ranks[r][name], inputs["ag"].reshape(N * 2, 5))


def test_psum_sums_in_rank_order_on_every_rank(runs):
    inputs, ranks, _ = runs
    want = inputs["ps"][0]
    for r in range(1, N):
        want = want + inputs["ps"][r]
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["psum"], want)
        assert ranks[r]["psum"].dtype == np.float32
        np.testing.assert_array_equal(ranks[r]["psum_count"], [N * (N + 1) // 2])
        assert ranks[r]["psum_count"].dtype == np.int32


def test_ring_needs_a_divisible_leading_dim(runs):
    _, ranks, _ = runs
    assert all(bool(ranks[r]["bad_raised"]) for r in range(N))
    with pytest.raises(ValueError):  # the JAX ring refuses it too
        _shard_map(lambda xl: jcoll.ring_reduce_scatter(xl[0], "x", N)[None],
                   jmesh.make_mesh((N,), ("x",), devices=jax.devices()[:N]), (P("x", None, None),),
                   P("x", None, None))(jnp.zeros((N, N * 2 + 1, 3), jnp.float32))


def test_one_device_axis_is_the_identity_and_local_axes_refuse():
    one = tmesh.make_mesh((1,), ("x",), devices=["cpu"])
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    assert torch.equal(tcoll.ring_all_reduce(x, one, "x"), x) and torch.equal(tcoll.psum(x, one, "x"), x)
    assert torch.equal(tcoll.ring_reduce_scatter(x, one, "x"), x)
    two = tmesh.make_mesh((2,), ("x",), devices=["cpu", "cpu"])
    assert two.shape == {"x": 2} and two.axis_devices("x") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="process group"):
        tcoll.psum(x, two, "x")
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh((3,), ("x",), devices=["cpu", "cpu"])
