"""The harness's files, arithmetic and contract, on the CPU."""

import json
import math
import re
import shutil

import pytest

import harness
import roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_every_cell_finds_its_files_by_name(manifest):
    for cell in manifest["workloads"]:
        cfg = harness.load_json("configs", cell["config"])
        traffic = harness.load_json("traffic", cell["traffic"])
        limits = harness.load_json("limits", cell["name"])
        assert hasattr(harness.load_module("drivers", traffic["driver"]), "Driver")
        assert cfg["height"] > 0 and traffic["loop_frames"] > 0 and limits["samples"] > 0
    for metric in manifest["per_layer"]:
        assert callable(harness.load_module("metrics", metric["name"]).read)


def test_manifest_keeps_the_contract(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in manifest["configs"]]
    cells = [w["name"] for w in manifest["workloads"]]
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("vo_bench/")
        assert c["name"] in {w["config"] for w in manifest["workloads"]}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["config"] in names and w["chips"] in (1, 4)
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "bound" not in m
        for cell in m["workloads"]:  # each cell that reads it reports what it moves
            assert m["moves"] in [x["name"] for x in harness.cell_metrics(manifest, "end_to_end", cell)]
    for cell in cells:
        assert len(harness.cell_metrics(manifest, "end_to_end", cell)) >= 2
        assert harness.cell_metrics(manifest, "per_layer", cell)


def test_a_cell_added_as_files_alone_is_found(tmp_path, manifest):
    root = tmp_path / "bench"
    shutil.copytree(harness.BENCH_DIR, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "drivers" / "dummy.py").write_text("class Driver:\n    kind = 'dummy'\n")
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps({"driver": "dummy", "loop_frames": 4}))
    (root / "configs" / "dummy_cfg.json").write_text(json.dumps({"height": 2, "lanes": 1}))
    (root / "limits" / "dummy_cell.json").write_text(json.dumps({"samples": 1}))
    (root / "metrics" / "dummy_metric.x.py").write_text("def read(record):\n    return record['n']\n")
    added = dict(manifest)
    added["workloads"] = manifest["workloads"] + [
        {"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1, "why": "a test"}]
    added["per_layer"] = manifest["per_layer"] + [
        {"name": "dummy_metric.x", "unit": "ms", "better": "lower", "source": "host_clock", "layer": "host tracker",
         "moves": "setup_s", "workloads": ["dummy_cell"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    found = harness.load_manifest(tmp_path / "BENCHMARK.json")
    cell = harness.find_cell(found, "dummy_cell")
    traffic = harness.load_json("traffic", cell["traffic"], root)
    assert harness.load_module("drivers", traffic["driver"], root).Driver.kind == "dummy"
    assert harness.load_json("configs", cell["config"], root)["height"] == 2
    assert harness.load_json("limits", cell["name"], root)["samples"] == 1
    per_layer = harness.cell_metrics(found, "per_layer", "dummy_cell")
    assert [m["name"] for m in per_layer] == ["dummy_metric.x"]
    assert harness.load_module("metrics", "dummy_metric.x", root).read({"n": 3}) == 3
    assert [m["name"] for m in harness.cell_metrics(found, "end_to_end", "dummy_cell")] == ["setup_s"]


def test_import_check_compares_whole_top_level_names():
    loaded = ["jax", "jaxlib.xla_client", "flax.linen", "visual_odometry_rs_tpu", "visual_odometry_rs_tpu.ops.pyramid",
              "visual_odometry_rs_tpu_torch", "visual_odometry_rs_tpu_torch.models.tracker", "jaxtyping", "torch"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jaxlib.xla_client", "visual_odometry_rs_tpu", "visual_odometry_rs_tpu.ops.pyramid"]
    assert harness.forbidden_modules(["visual_odometry_rs_tpu_torch.ops", "numpy"]) == []


def test_percentile():
    values = [float(v) for v in range(1, 101)]
    assert harness.percentile(values, 50) == 50.0
    assert harness.percentile(values, 95) == 95.0
    assert harness.percentile([3.0, 1.0, 2.0], 100) == 3.0
    assert harness.percentile(values[:19] + [math.inf], 95) == 19.0
    assert harness.percentile(values[:19] + [math.inf], 96) == math.inf


def test_union_covered_and_gaps():
    device = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (10.0, 11.0)]
    assert harness.union(device) == [(0.0, 2.0), (3.0, 4.0), (10.0, 11.0)]
    within = [(1.0, 3.5), (9.0, 10.5)]
    assert harness.covered(device, within) == pytest.approx(1.0 + 0.5 + 0.5)
    assert harness.gaps(device, within) == [(2.0, 3.0), (9.0, 10.0)]
    assert harness.count_in([0.5, 1.5, 2.5, 9.5, 12.0], within) == 3


def _trace():
    # two frames: 0-10 ms and 40-50 ms; the device busy 2-4, 3-7 and 41-42 ms
    ms = 1e-3
    return {"device": [(2 * ms, 4 * ms, "lm_solve_level_kernel<6>"), (3 * ms, 7 * ms, "copy"),
                       (41 * ms, 42 * ms, "lm_solve_level_kernel<6>")],
            "launches": [1 * ms, 2 * ms, 41 * ms, 60 * ms], "spans": [],
            "host_ops": [(6 * ms, 9 * ms, "aten::cumsum"), (6.5 * ms, 7 * ms, "aten::empty")]}


def _live_record():
    ms = 1e-3
    frames = [{"due": i * 0.033, "start": i * 0.033, "end": i * 0.033 + d, "switched": sw, "failed": False,
               "traced": i < 2}
              for i, (d, sw) in enumerate([(3 * ms, False), (30 * ms, True), (3 * ms, False), (4 * ms, False),
                                           (33 * ms, True), (5 * ms, False)])]
    spans = [(0.0, 10 * ms), (40 * ms, 50 * ms)]
    return {"kind": "live", "seconds": 0.2, "frames": frames, "trace": _trace(), "trace_spans": spans,
            "trace_window": (0.0, 50 * ms), "device_name": "NVIDIA H100 80GB HBM3",
            "solver_launches": [{"n": 1024, "height": 60, "width": 80, "lanes": 1, "evaluations": 5}] * 2}


def test_live_metrics_on_made_up_frames():
    rec = _live_record()
    live = harness.load_module("drivers", "live").Driver
    e2e = live.end_to_end(rec)
    assert e2e["frame_ms_p50"] == pytest.approx(4.0) and e2e["frame_ms_p95"] == pytest.approx(33.0)
    rec["frames"][1]["failed"] = True  # a failed frame counts as missing: as late as the window
    assert live.end_to_end(rec)["frame_ms_p95"] == pytest.approx(200.0)
    read = {name: harness.load_module("metrics", name).read(rec) for name in (
        "steady_frame_ms.live", "switch_frame_ms.live", "launches_per_frame.live", "device_idle_pct.live")}
    assert read["steady_frame_ms.live"] == pytest.approx(4.0)  # untraced steady frames: 3, 4, 5 ms
    assert read["switch_frame_ms.live"] == pytest.approx(33.0)
    assert read["launches_per_frame.live"] == pytest.approx(1.5)  # 3 launches in 2 spans
    assert read["device_idle_pct.live"] == pytest.approx(100.0 * (1 - 6.0 / 20.0))
    no_trace = dict(rec, trace=None, trace_spans=[], trace_window=None)
    assert harness.load_module("metrics", "device_idle_pct.live").read(no_trace) is None
    assert harness.load_module("metrics", "lm_solve_roofline.live").read(no_trace) is None


def test_batch_metrics_on_made_up_clips():
    batch = harness.load_module("drivers", "offline_batch").Driver
    rec = {"kind": "offline_batch", "seconds": 2.0, "trace": _trace(), "trace_spans": [(0.0, 0.05)],
           "trace_window": (0.0, 0.05), "traced_lane_frames": 4, "device_name": "NVIDIA H100 80GB HBM3",
           "solver_launches": [], "clips": [{"lane_frames": 256, "failed": 6}, {"lane_frames": 256, "failed": 0}]}
    assert batch.end_to_end(rec)["frames_per_s"] == pytest.approx(506 / 2.0)
    assert batch.counts(rec) == (512, 6)
    assert harness.load_module("metrics", "launches_per_frame.batch").read(rec) == pytest.approx(3 / 4)
    assert harness.load_module("metrics", "device_idle_pct.batch").read(rec) == pytest.approx(100 * (1 - 6 / 50))
    assert harness.load_module("metrics", "lm_solve_roofline.batch").read(rec) is None  # no launch recorded


def test_breakdown_names_ops_and_gaps():
    b = harness.breakdown(_trace(), [(0.0, 0.010)])
    assert b["device_ops"][0] == ["copy", pytest.approx(0.004)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # 0-2 ms: nothing on the host; 7-10 ms: its middle (8.5 ms) inside aten::cumsum
    assert gaps["host: python"] == pytest.approx(0.002) and gaps["aten::cumsum"] == pytest.approx(0.003)


def test_roofline_counts_at_a_known_shape():
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.peaks("some other card") is None
    # level 0 at 640x480, the cap 8192: 41 B a candidate, the u8 image, the 128-float record
    assert roofline.launch_bytes(8192, 480, 640, 1) == 8192 * 41 + 307200 + 512 == 643584
    assert roofline.launch_bytes(8192, 480, 640, 32) == 32 * 643584
    assert roofline.launch_flops(8192, 5) == 5 * 8192 * 47
    launch = {"n": 8192, "height": 480, "width": 640, "lanes": 1, "evaluations": 5}
    assert roofline.least_seconds([launch], peak) == pytest.approx(643584 / 3.35e12)
    many = dict(launch, evaluations=10_000)  # the operations bound it
    assert roofline.least_seconds([many], peak) == pytest.approx(10_000 * 8192 * 47 / 67e12)
    rec = {"trace": {"device": [(0.0, 20e-6, "lm_solve_level_kernel<6, false>")]}, "solver_launches": [launch],
           "device_name": "NVIDIA H100 80GB HBM3"}
    assert roofline.share_pct(rec, "lm_solve_level_kernel") == pytest.approx(100 * (643584 / 3.35e12) / 20e-6)
