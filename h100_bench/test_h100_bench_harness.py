"""CPU tests of the benchmark's harness: discovery by name, the traffic, the
work counts and the import rules.  Run from the repository root:
``python -m pytest h100_bench -q``."""

import ast
import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import generator  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402
import traffic  # noqa: E402
import work  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = dict(function="make_ba_problem", num_poses=10, num_landmarks=150, kind="mono", seed=None)


def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark's data files with its configurations cut to
    a few poses, so that a whole run fits a CPU test."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(HERE / sub, tmp_path / harness.FOLDER / sub)
    for c in BENCH["configs"]:
        p = tmp_path / c["file"]
        cfg = json.loads(p.read_text())
        cfg["generator"].update(num_poses=10, num_landmarks=150)
        p.write_text(json.dumps(cfg))
    return tmp_path


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload, trace):
    cell = harness.load_cell(ROOT, workload, trace)
    w = next(x for x in BENCH["workloads"] if x["name"] == workload)
    assert cell.config["name"] == w["config"]
    assert set(check_names()) <= set(cell.limits)
    names = [m["name"] for m, _ in cell.metrics]
    here = [m for m in BENCH["end_to_end"] if workload in m.get("workloads", [workload])]
    if trace:
        here = [m for m in BENCH["per_layer"] if workload in m.get("workloads", [workload])
                and m["moves"] in {e["name"] for e in here}]
    assert names == [m["name"] for m in here] and names


def check_names():
    import check

    return check.NAMES


def test_a_cell_config_mix_and_metric_are_added_by_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    folder = root / harness.FOLDER
    (folder / "configs" / "tiny_mono.json").write_text(json.dumps(dict(
        name="tiny_mono", generator={k: v for k, v in TINY.items() if k != "seed"},
        options={"dtype": "float64", "solver_precision": "mixed"}, robust_kernel=0, delta=1.0,
        iterations=5, reduced=[])))
    (folder / "traffic" / "grow_fifth.json").write_text(json.dumps({"growth_span": 0.2, "graphs": 8}))
    (folder / "metrics" / "solves_done.py").write_text("def read(run):\n    return len(run.solves)\n")
    (folder / "limits" / "tiny_mono.grow_fifth.json").write_text(json.dumps(
        {"chi2_gap": 1e-8, "pose_gap": 1e-7, "landmark_gap": 1e-7}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_mono", "source": "test", "file": "h100_bench/configs/tiny_mono.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_mono.grow_fifth", "config": "tiny_mono",
                               "traffic": "grow_fifth", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "solves_done", "unit": "solves", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny_mono.grow_fifth"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, checks = harness.run_cell(root, "tiny_mono.grow_fifth", 7, 0.2, False, "cpu",
                                      log=lambda s: None)
    assert result["correct"], checks
    assert result["metrics"]["solves_done"]["value"] == result["attempted"] >= 1
    want = {m["name"] for m in bench["end_to_end"]
            if "tiny_mono.grow_fifth" in m.get("workloads", ["tiny_mono.grow_fifth"])}
    assert "solves_done" in want and set(result["metrics"]) == want - (
        {n for n in want if "p90" in n} if result["attempted"] < 2 else set())
    assert list(result)[-1] == "checks"
    # a metric that lists other cells is not this cell's
    other = harness.load_cell(root, BENCH["workloads"][0]["name"], False)
    assert "solves_done" not in [m["name"] for m, _ in other.metrics]


def _digest(p) -> str:
    h = hashlib.sha256()
    for s in traffic.edge_sets(p):
        h.update(np.ascontiguousarray(s["pose_idx"]).tobytes())
        h.update(np.ascontiguousarray(s["lm_idx"]).tobytes())
    return h.hexdigest()


def test_new_graph_draws_a_new_index_digest_every_solve_and_repeats_by_seed():
    base = generator.make_mixed_ba_problem(num_poses=40, num_landmarks=2000, seed=3)
    params = json.loads((HERE / "traffic" / "new_graph.json").read_text())
    n = traffic.Mix(base, params, 0).n
    assert n == round(params["growth_span"] * 2000) < params["graphs"]
    a = [traffic.Mix(base, params, 2**31 + 5).problem(k) for k in range(-1, n - 1)]
    b = [traffic.Mix(base, params, 2**31 + 5).problem(k) for k in range(-1, n - 1)]
    c = [traffic.Mix(base, params, 2**33 + 6).problem(k) for k in range(-1, n - 1)]
    da, db, dc = ([_digest(p) for p in x] for x in (a, b, c))
    # every solve a graph of its own, the same ones for the same seed; another
    # seed brings the same sizes in another order
    assert len(set(da)) == n and da == db and da != dc and set(da) == set(dc)
    assert sorted(p.landmarks.shape[0] for p in a) == list(range(2001 - n, 2001))
    seq = np.concatenate([np.arange(1, 40), [0]])  # a packed pose's place in the sequence
    for p in a:
        m, Pa = p.landmarks.shape[0], p.num_active_poses
        assert m == p.num_active_landmarks and np.array_equal(p.landmarks, base.landmarks[:m])
        assert np.array_equal(p.pose_q, np.concatenate([base.pose_q[:Pa], base.pose_q[-1:]]))
        used = np.zeros(Pa + 1, int)
        for s, s0 in zip(p.specs, base.specs):
            assert s["kind"] == s0["kind"] and s["lm_idx"].dtype == s0["lm_idx"].dtype
            np.add.at(used, s["pose_idx"], 1)
            # the observations of the grown map, as the seed's graph has them
            keep = (s0["lm_idx"] < m) & (seq[s0["pose_idx"]] <= Pa)
            assert np.array_equal(s["meas"], s0["meas"][keep])
            assert np.array_equal(s["lm_idx"], s0["lm_idx"][keep])
            assert np.array_equal(seq[s0["pose_idx"][keep]], np.where(
                s["pose_idx"] < Pa, s["pose_idx"] + 1, 0))
        assert used.min() > 0  # every keyframe of the map observes something


def test_a_growing_mono_map_keeps_its_problem_type():
    base = generator.make_ba_problem(num_poses=20, num_landmarks=500, seed=3)
    mix = traffic.Mix(base, {"growth_span": 0.2, "graphs": 7}, 1)
    p = mix.problem(0)
    assert type(p) is type(base) and mix.n == 7 and p.meas.shape[1] == 2
    assert p.pose_idx.max() == p.num_active_poses and p.lm_idx.max() < p.landmarks.shape[0]


def test_same_graph_resends_the_seed_graph():
    base = generator.make_mixed_ba_problem(num_poses=20, num_landmarks=500, seed=3)
    params = json.loads((HERE / "traffic" / "same_graph.json").read_text())
    mix = traffic.Mix(base, params, 11)
    assert all(mix.problem(k) is base and mix.graph_key(k) == 0 for k in range(-1, 4))


def test_unknown_traffic_parameter_is_refused():
    base = generator.make_ba_problem(num_poses=8, num_landmarks=64, seed=0)
    with pytest.raises(ValueError):
        traffic.Mix(base, {"drop_fraction": 0.1}, 0)
    with pytest.raises(ValueError):
        traffic.Mix(base, {"growth_span": 0.1, "clients": 4}, 0)


def test_work_counts_equal_hand_counts_on_a_tiny_graph():
    # 3 poses (pose 2 fixed), 3 landmarks (landmark 2 fixed); landmark 0 seen
    # by poses 0 and 1, landmark 1 by poses 0, 1 and 2, landmark 2 by pose 1
    p = generator.BAProblem(
        pose_q=np.zeros((3, 4)), pose_t=np.zeros((3, 3)), num_active_poses=2,
        landmarks=np.zeros((3, 3)), num_active_landmarks=2, meas=np.zeros((6, 2)),
        pose_idx=np.array([0, 1, 0, 1, 2, 1], np.int32), lm_idx=np.array([0, 0, 1, 1, 1, 2], np.int32),
        omega=np.ones(6), cam=np.zeros(5), kind="mono")
    s = work.shapes(p)
    # free edges: (0,0) (1,0) (0,1) (1,1); each landmark has 2 of them: 3 products
    assert s == work.Shapes(P=3, Pa=2, L=3, La=2, E=6, Epl=4, rows=12, idx_bytes=4, pairs=6, blocks=3)
    w = 8
    st = work.stage_work(s, w)
    state = (3 * 7 + 3 * 3) * w
    edges = 6 * (2 * w + 2 * 4 + w) + 5 * w
    assert st["linearise"][0] == state + edges + 2 * 42 * w + 2 * 12 * w + 4 * 18 * w
    assert st["schur"][0] == 2 * 42 * w + 2 * 12 * w + 4 * 18 * w + w + 3 * 36 * w + 2 * 6 * w
    assert st["solve"] == (3 * 36 * w + 2 * 2 * 6 * w, 2 * (2 * 3 - 2) * 36)
    assert st["back"][0] == 4 * 18 * w + 2 * 12 * w + 2 * 6 * w + 2 * 3 * w
    assert st["linearise"][1] == 6 * (18 + 7 + 2 + 18 + 54 * 3) + 3 * 30
    assert st["schur"][1] == 2 * 43 + 4 * 120 + 6 * 180
    lin = work.stage_seconds(*st["linearise"], w)
    assert lin == max(st["linearise"][0] / 3.35e12, st["linearise"][1] / 34e12)
    trial = sum(work.stage_seconds(*st[k], w) for k in ("schur", "solve", "back", "update"))
    assert work.solve_seconds(s, 10, 12, w) == pytest.approx(10 * lin + 12 * trial, rel=1e-15)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "cuda_bundle_adjustment_tpu"}
    files = sorted(HERE.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & forbidden, (f, tops & forbidden)


@pytest.mark.parametrize("name", ["reference.py", "check.py", "work.py", "generator.py", "traffic.py"])
def test_the_yardstick_imports_nothing_of_the_port(name):
    tops = {n.split(".")[0] for n in _imports(HERE / name)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, tops


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "cuda_bundle_adjustment_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cuda_bundle_adjustment_tpu.probe", object())
    assert run.forbidden_modules() == ["cuda_bundle_adjustment_tpu"]


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert "{" not in capsys.readouterr().out
