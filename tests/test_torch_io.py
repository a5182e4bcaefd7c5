"""The port's IO and evaluation against PIL and the JAX package.

- ``native`` (``csrc/vors_io.cpp``, PNG decoded on zlib alone): every color
  type and bit depth, interlaced or not, bit-equal to PIL and to the JAX
  package's ``native`` readers (libpng) on the same files; an 8-bit PNG is
  refused as depth; a corrupted file raises; the prefetch loader delivers
  in order and reports a decode error at its frame.
- ``tum_rgbd.write_png``/``write_sequence``: read back bit-equal by PIL and
  by the JAX package.
- ``parse_trajectory``: equal poses (both f32); ``rpe_rmse``: ``rtol=1e-5``
  (both f32 pose algebra, summed in another order); the inverse-depth
  fusions: states equal, values ``rtol=1e-6``.
- ``vors_eval``: the same JSON line as the JAX CLI on the same files.
"""

import io
import struct
import zlib
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visual_odometry_rs_tpu import native as jnative
from visual_odometry_rs_tpu.cli import vors_eval as jeval_cli
from visual_odometry_rs_tpu.core import inverse_depth as jidepth
from visual_odometry_rs_tpu.dataset import tum_rgbd as jtum
from visual_odometry_rs_tpu.eval import ate as jate
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu_torch import native
from visual_odometry_rs_tpu_torch.cli import vors_eval as teval_cli
from visual_odometry_rs_tpu_torch.core import inverse_depth as tidepth
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.math.pose import Pose

torch.set_num_threads(1)

H, W = 29, 43  # odd sizes: ragged bit packing and Adam7 passes


def _rng():
    return np.random.default_rng(0)


def _smooth(dtype, scale):
    yy, xx = np.mgrid[0:H, 0:W]
    noise = _rng().integers(0, 3, (H, W))
    return ((xx * 5 + yy * 3 + noise) * scale % (np.iinfo(dtype).max + 1)).astype(dtype)


def _pil_images():
    rgb = _rng().integers(0, 256, (H, W, 3), dtype=np.uint8)
    return {
        "gray8": Image.fromarray(_smooth(np.uint8, 1), "L"),
        "gray16": Image.fromarray(_smooth(np.uint16, 300)),
        "rgb": Image.fromarray(rgb, "RGB"),
        "rgba": Image.fromarray(_rng().integers(0, 256, (H, W, 4), dtype=np.uint8), "RGBA"),
        "gray_alpha": Image.fromarray(_rng().integers(0, 256, (H, W, 2), dtype=np.uint8), "LA"),
        "palette8": Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE, colors=200),
        "palette4": Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE, colors=16),
        "gray1": Image.fromarray(_smooth(np.uint8, 1), "L").convert("1"),
    }


def _filter_row(row, prev, kind):
    """PNG row filter ``kind`` of one row of bytes (one byte a pixel)."""
    row, prev = row.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([[0], row[:-1]])
    upleft = np.concatenate([[0], prev[:-1]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((row - pred) % 256).astype(np.uint8)


def _interlaced_png(img: np.ndarray) -> bytes:
    """An Adam7-interlaced 8-bit gray PNG of ``img``, the rows cycling
    through the five filters (PIL writes no interlaced PNG)."""
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    raw, kind = bytearray(), 0
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = np.zeros(sub.shape[1], np.uint8)
        for row in sub:
            raw += bytes([kind]) + _filter_row(row, prev, kind).tobytes()
            prev, kind = row, (kind + 1) % 5

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 0, 0, 0, 1)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(raw))) + \
        chunk(b"IEND", b"")


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    directory = tmp_path_factory.mktemp("pngs")
    paths = {}
    for name, img in _pil_images().items():
        paths[name] = str(directory / f"{name}.png")
        img.save(paths[name], **({"bits": 4} if name == "palette4" else {}))
    paths["interlaced"] = str(directory / "interlaced.png")
    with open(paths["interlaced"], "wb") as f:
        f.write(_interlaced_png(_rng().integers(0, 256, (H, W), dtype=np.uint8)))
    assert native.available() and jnative.available()
    return paths


def _pil_luma(path):
    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB") if img.mode in ("P", "RGBA") else img)
    if img.mode == "LA":
        arr = arr[..., 0]
    if arr.ndim == 2:
        return arr.astype(np.uint8) * (255 if img.mode == "1" else 1)
    rgb = arr[..., :3].astype(np.uint32)
    return ((299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2]) // 1000).astype(np.uint8)


@pytest.mark.parametrize(
    "name", ["gray8", "rgb", "rgba", "gray_alpha", "palette8", "palette4", "gray1", "interlaced"]
)
def test_read_gray_matches_pil_and_libpng(png_files, name):
    path = png_files[name]
    out = native.read_gray(path)
    assert out.dtype == np.uint8 and out.shape == (H, W) and native.png_dims(path) == (H, W)
    np.testing.assert_array_equal(out, jnative.read_gray(path))
    if name != "interlaced":
        np.testing.assert_array_equal(out, _pil_luma(path))
    else:
        with Image.open(path) as img:
            np.testing.assert_array_equal(out, np.asarray(img))


def test_read_depth_matches_pil_and_libpng(png_files):
    path = png_files["gray16"]
    out = native.read_png_16bits(path)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, jnative.read_png_16bits(path))
    with Image.open(path) as img:
        np.testing.assert_array_equal(out, np.asarray(img).astype(np.uint16))
    # to_luma of 16-bit gray keeps the high byte
    np.testing.assert_array_equal(native.read_gray(path), jnative.read_gray(path))


def test_depth_refuses_8_bits_and_corrupt_files(png_files, tmp_path):
    with pytest.raises(IOError, match="16-bit"):
        native.read_png_16bits(png_files["gray8"])
    data = bytearray(open(png_files["gray16"], "rb").read())
    data[60] ^= 0xFF  # inside IDAT: the chunk's CRC no longer matches
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(IOError, match="CRC"):
        native.read_png_16bits(str(bad))
    bad.write_bytes(b"not a png at all")
    with pytest.raises(IOError, match="not a PNG"):
        native.png_dims(str(bad))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    rng = np.random.default_rng(3)
    grays = rng.integers(0, 256, (5, 24, 32), dtype=np.uint8)
    depths = rng.integers(0, 65536, (5, 24, 32), dtype=np.uint16)
    directory = str(tmp_path_factory.mktemp("seq"))
    assoc = ttum.write_sequence(directory, grays, depths, np.arange(5, dtype=np.float64) + 0.5)
    return ttum.load_associations(assoc), grays, depths


def test_writer_read_back_by_pil_and_jax(sequence):
    assocs, grays, depths = sequence
    for a, gray, depth in zip(assocs, grays, depths):
        for path, ref, read in ((a.depth_file_path, depth, jtum.read_png_16bits), (a.color_file_path, gray,
                                                                                   jtum.read_gray)):
            with Image.open(path) as img:
                np.testing.assert_array_equal(np.asarray(img).astype(ref.dtype), ref)
            np.testing.assert_array_equal(read(path), ref)
        d, g = ttum.read_images(a)
        np.testing.assert_array_equal(d, depth)
        np.testing.assert_array_equal(g, gray)
    with pytest.raises(ValueError):
        ttum.write_png("unused.png", np.zeros((2, 2), np.float32))


def test_prefetch_loader_in_order_and_errors(sequence, tmp_path):
    assocs, grays, depths = sequence
    frames = list(ttum.frame_loader(assocs, num_threads=3, max_ahead=2))
    assert len(frames) == len(assocs)
    for (d, g), depth, gray in zip(frames, depths, grays):
        np.testing.assert_array_equal(d, depth)
        np.testing.assert_array_equal(g, gray)
    depth_paths = [a.depth_file_path for a in assocs]
    depth_paths[2] = str(tmp_path / "missing.png")
    with native.PrefetchLoader(depth_paths, [a.color_file_path for a in assocs], 24, 32, num_threads=4) as loader:
        np.testing.assert_array_equal(next(loader)[0], depths[0])
        np.testing.assert_array_equal(next(loader)[0], depths[1])
        with pytest.raises(IOError, match="missing.png"):
            next(loader)
        np.testing.assert_array_equal(next(loader)[1], grays[3])


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


def _trajectory_text(q, t, stamps):
    return "# a comment\n" + "\n".join(
        jtum.Frame(timestamp=float(s), pose=JPose(q=qi, t=ti)).to_string() for s, qi, ti in zip(stamps, q, t)
    ) + "\n"


def test_parse_trajectory_matches_jax():
    q, t = _poses(4, 1)
    text = _trajectory_text(q, t, [1.0, 1.5, 2.25, 3.0])
    out, ref = ttum.parse_trajectory(text), jtum.parse_trajectory(text)
    assert [f.timestamp for f in out] == [f.timestamp for f in ref]
    for o, r in zip(out, ref):
        assert o.pose.q.dtype == torch.float32
        np.testing.assert_array_equal(o.pose.q.numpy(), np.asarray(r.pose.q))
        np.testing.assert_array_equal(o.pose.t.numpy(), np.asarray(r.pose.t))
    with pytest.raises(ValueError):
        ttum.parse_trajectory("1.0 0 0 0 0 0 1\n")


@pytest.mark.parametrize("delta", [1, 3, 12])
def test_rpe_matches_jax(delta):
    (q, t), (gq, gt) = _poses(12, 2), _poses(12, 3)
    est = [Pose(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(q, t)]
    gtp = [Pose(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(gq, gt)]
    out = tate.rpe_rmse(est, gtp, delta=delta)
    ref = jate.rpe_rmse([JPose(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(q, t)],
                        [JPose(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(gq, gt)], delta=delta)
    if delta >= 12:
        assert out == ref == (0.0, 0.0)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    with pytest.raises(ValueError, match="length"):
        tate.rpe_rmse(est, gtp[:-1])


def _idepth_map(module, array_fn):
    rng = np.random.default_rng(4)
    idepth = rng.uniform(0.2, 1.0, (16, 24)).astype(np.float32)
    idepth[:, 1::2] = idepth[:, ::2] * 1.001  # blocks of nearly equal values: some pass the gate
    idepth[8:, 1::2] = idepth[8:, ::2] + 0.3  # and some fail it
    variance = rng.uniform(1e-4, 2e-2, (16, 24)).astype(np.float32)
    state = rng.choice([0, 1, 2, 2, 2], (16, 24)).astype(np.uint8)
    return module.InverseDepthMap(array_fn(idepth), array_fn(variance), array_fn(state))


@pytest.mark.parametrize("strategy", ["dso_mean", "statistically_similar"])
def test_inverse_depth_fusions_match_jax(strategy):
    out = tidepth.pyramid(_idepth_map(tidepth, torch.from_numpy), 4, strategy=strategy)
    ref = jidepth.pyramid(_idepth_map(jidepth, jnp.asarray), 4, strategy=strategy)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.state.numpy(), np.asarray(r.state))
        np.testing.assert_allclose(o.idepth.numpy(), np.asarray(r.idepth), rtol=1e-6)
        np.testing.assert_allclose(o.variance.numpy(), np.asarray(r.variance), rtol=1e-6)
    if strategy != "dso_mean":  # the gate discards some blocks and keeps others
        states = np.asarray(ref[1].state)
        assert (states == jidepth.DISCARDED).any() and (states == jidepth.WITH_VARIANCE).any()


def _stdout(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--delta", "2", "--scale"], ["--delta", "9"]])
def test_vors_eval_prints_the_jax_json(tmp_path, extra):
    q, t = _poses(8, 5)
    gq, gt = _poses(9, 6)
    est = tmp_path / "est.txt"
    est.write_text(_trajectory_text(q, t, np.arange(8) * 0.1 + 0.105))  # matched within --max-dt
    ground = tmp_path / "gt.txt"
    ground.write_text(_trajectory_text(gq, gt, np.arange(9) * 0.1))
    argv = [str(ground), str(est), *extra]
    out, ref = _stdout(teval_cli.main, argv), _stdout(jeval_cli.main, argv)
    assert out == ref and out[0] == 0
    if extra[-1:] == ["9"]:
        assert '"rpe_trans_rmse_m": null' in out[1]
    est.write_text("1.0 0 0 0 0 0 1\n")  # seven columns
    assert teval_cli.main(argv) == jeval_cli.main(argv) == 1
