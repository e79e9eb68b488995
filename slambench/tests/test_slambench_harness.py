"""The harness finds its parts by name, keeps to the benchmark's contract,
and computes its metrics right."""

import json
import os
import re
import statistics

import numpy as np
import pytest

from slambench import harness, peaks, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_throwaway_parts_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a route and a per-layer metric added
    as files of their own are found with no edit to any file."""
    base = str(tmp_path)
    for kind in ("configs", "traffic", "routes", "metrics", "limits"):
        os.makedirs(os.path.join(base, kind))
    with open(os.path.join(base, "configs", "tiny_cfg.json"), "w") as f:
        json.dump({"slam": {"max_landmarks": 8}, "session": {"chunk": 2}}, f)
    with open(os.path.join(base, "traffic", "tiny.mix.json"), "w") as f:
        json.dump({"route": "walk", "lap": {"frames": 4}}, f)
    with open(os.path.join(base, "routes", "walk.py"), "w") as f:
        f.write("class Route:\n    KIND = 'walk'\n")
    with open(os.path.join(base, "metrics", "ops_per_frame.walk.py"),
              "w") as f:
        f.write("def read(t, cell):\n    return 42.0\n")
    with open(os.path.join(base, "limits", "tiny.json"), "w") as f:
        json.dump({"limits": {"pose_gap": 1e-3}}, f)
    assert harness.config("tiny_cfg", base)["session"]["chunk"] == 2
    assert harness.traffic("tiny.mix", base)["route"] == "walk"
    assert harness.route("walk", base).Route.KIND == "walk"
    assert harness.metric("ops_per_frame.walk", base).read(None, {}) == 42.0
    assert harness.limits("tiny", base) == {"pose_gap": 1e-3}
    with pytest.raises(FileNotFoundError):
        harness.route("absent", base)


def test_cells_find_their_parts():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        harness.config(w["config"])
        t = harness.traffic(w["traffic"])
        harness.route(t["route"])
        lim = harness.limits(w["name"])
        assert lim["decisions_off"] == 0 and lim["frame_count"] == 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric(m["name"]).read)


def test_benchmark_file_keeps_the_contract():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "slambench/run.py"]
    assert bench["paths"] == ["slambench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.cell_metrics(
                bench, w, "end_to_end")}
    for w in bench["workloads"]:
        assert any(harness.cell_metrics(bench, w["name"], "per_layer"))
        assert len(harness.cell_metrics(bench, w["name"], "end_to_end")) >= 2


@pytest.mark.parametrize("modules,found", [
    ({"cv_monoslam_tpu_torch": 1, "cv_monoslam_tpu_torch.api": 1}, []),
    ({"cv_monoslam_tpu.api": 1, "torch": 1}, ["cv_monoslam_tpu"]),
    ({"jaxlib.xla_client": 1, "jax": 1}, ["jax", "jaxlib"]),
    ({"jaxtyping": 1, "flaxen": 1}, []),
])
def test_forbidden_names_compare_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def _trace(device, frames=2, wall_us=100.0, M=32, host=()):
    return trace.Trace(frames=frames, window_us=400.0, device=list(device),
                       host=list(host), wall_us_per_frame=wall_us, M=M)


def test_union_and_idle_share():
    spans = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0),
             ("d", 32.0, 35.0)]
    t = _trace(spans, frames=2, wall_us=25.0)
    assert trace.union_us([(a, b) for _, a, b in spans]) == 30.0
    idle = harness.metric("device_idle_pct.replay").read(t, {})
    assert idle == pytest.approx(100.0 * (1 - 15.0 / 25.0))
    assert harness.metric("device_ms_per_frame.replay").read(t, {}) == \
        pytest.approx(15.0 / 1e3)
    assert harness.metric("device_ops_per_frame.live").read(t, {}) == 2.0
    assert harness.metric("device_idle_pct.live").read(_trace([]), {}) \
        is None


def test_kernel_metrics_and_roofline():
    spans = [("warp_ncc_score_map_kernel", 0.0, 20.0),
             ("warp_ncc_score_map_kernel", 30.0, 52.0),
             ("warp_ncc_score_map_kernel", 60.0, 81.0),
             ("void potrf_alg2_cta_upper<float>", 90.0, 190.0),
             ("sm90_xmma_gemm_f32", 200.0, 250.0),
             ("store_slots_kernel", 260.0, 266.0),
             ("void at::native::vectorized_elementwise_kernel", 270.0, 280.0)]
    t = _trace(spans, frames=2, M=576)
    bound_ms = peaks.warp_ncc_bound(576)["bound_ms"]
    assert bound_ms == pytest.approx(2.628e-3, rel=2e-3)  # chip_smoke's
    assert harness.metric("warp_ncc_score_map_roofline").read(t, {}) == \
        pytest.approx(100.0 * bound_ms / 0.021)
    assert harness.metric("linalg_ms_per_frame.replay").read(t, {}) == \
        pytest.approx(150.0 / 2 / 1e3)
    assert harness.metric("scan_kernels_ms_per_frame.replay").read(
        t, {}) == pytest.approx(6.0 / 2 / 1e3)
    assert harness.metric("warp_ncc_score_map_roofline").read(
        _trace(spans[3:]), {}) is None


def test_breakdown_names_gaps_by_host_activity():
    dev = [("k1", 0.0, 5.0), ("k2", 50.0, 60.0), ("k1", 61.0, 70.0)]
    host = [("cudaGraphLaunch", 40.0, 49.0), ("slambench.run", 0.0, 80.0)]
    b = trace.breakdown(_trace(dev, host=host))
    assert b["device_ops"][0] == ["k1", pytest.approx(14e-6)]
    assert b["idle_gaps"] == [["slambench.run", pytest.approx(45e-6)]]


@pytest.mark.parametrize("n", [20, 101, 1000])
def test_percentile_over_every_frame(n):
    rng = np.random.default_rng(n)
    lat = list(rng.exponential(2e-3, n))
    win = type("W", (), {"latencies_s": lat})
    got = harness.metric("frame_ms_p95").read(win, 0.0)
    assert got == pytest.approx(np.percentile(np.asarray(lat) * 1e3, 95))
    assert sorted(lat)[int(0.9 * n)] * 1e3 <= got <= max(lat) * 1e3


def test_rate_over_the_whole_window():
    win = type("W", (), {"frames": 900, "wall_s": 20.0})
    assert harness.metric("frames_per_s").read(win, 1.0) == 45.0
    assert harness.metric("setup_s").read(win, 12.5) == 12.5


def test_spread_is_the_quartile_distance():
    """The spread the bounds were set from: ``statistics.quantiles``."""
    v = [453.6, 470.4, 517.2, 538.6, 513.9, 486.5]
    q = statistics.quantiles(v, n=4)
    assert (q[2] - q[0]) / statistics.median(v) == pytest.approx(0.1127,
                                                                abs=1e-3)


def test_reference_imports_nothing_of_the_program():
    """An AST walk of every module of the reference: no import of the
    port, of the JAX package, of JAX or of the rest of the benchmark."""
    import ast

    ref = os.path.join(harness.HERE, "reference")
    seen = 0
    for dirpath, _, files in os.walk(ref):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, fn)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    if node.level:
                        continue
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    seen += 1
                    top = m.split(".")[0]
                    assert top in ("torch", "numpy", "scipy", "math",
                                   "dataclasses", "contextlib",
                                   "contextvars", "itertools", "typing",
                                   "__future__", "json"), (fn, m)
    assert seen > 20
