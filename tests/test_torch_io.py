"""The port's graph files (OpenCV JSON FileStorage layout) and its two
samples on the CPU: the writer and readers against the JAX package's on the
same files, ``read_graph`` against ``read_problem``, and the committed
fixture's golden trace, held against the JAX package's as well."""

import json

import numpy as np
import pytest
import torch

import cuda_bundle_adjustment_tpu as jba
import cuda_bundle_adjustment_tpu_torch as tba
from chip_smoke import FIXTURE, GOLDEN_MIXED_TRACE
from cuda_bundle_adjustment_tpu.io import opencv_json as jio
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as joptimizer_from_problem
from cuda_bundle_adjustment_tpu.io import synthetic as jsyn
from cuda_bundle_adjustment_tpu_torch.io import opencv_json
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.samples import sample_ba_from_file, sample_comparison_with_cpu

torch.set_num_threads(1)


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _graph_optimizer(path):
    """The file through read_graph into the object API on the CPU (each
    edge's own information, as the file gives it)."""
    poses, landmarks, edge_sets, _ = opencv_json.read_graph(path)
    opt = tba.TorchGraphOptimisation.create(
        tba.GraphOptimisationOptions(per_edge_information=True), device="cpu")
    opt.add_vertex_set(poses)
    opt.add_vertex_set(landmarks)
    for es in edge_sets:
        opt.add_edge_set(es)
    opt.initialize()
    return opt


def _assert_problems_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "specs":
            assert len(a) == len(b)
            for sa, sb in zip(a, b):
                assert sa.keys() == sb.keys()
                for k in sa:
                    np.testing.assert_array_equal(sa[k], sb[k])
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_problem_roundtrip(tmp_path, kind):
    """write_graph then read_problem gives the problem back; the file and the
    arrays read are the JAX package's."""
    if kind == "mixed":
        problem = make_mixed_ba_problem(num_poses=6, num_landmarks=25, seed=43)
        jproblem = jsyn.make_mixed_ba_problem(num_poses=6, num_landmarks=25, seed=43)
    else:
        problem = make_ba_problem(num_poses=6, num_landmarks=25, kind=kind, seed=43)
        jproblem = jsyn.make_ba_problem(num_poses=6, num_landmarks=25, kind=kind, seed=43)
    path, jpath = str(tmp_path / "graph.json"), str(tmp_path / "jax.json")
    opencv_json.write_graph(path, problem=problem)
    jio.write_graph(jpath, problem=jproblem)
    with open(path) as f, open(jpath) as g:
        assert json.load(f) == json.load(g)

    back = opencv_json.read_problem(path)
    _assert_problems_equal(back, jio.read_problem(path))
    assert back.num_active_poses == problem.num_active_poses
    np.testing.assert_allclose(back.pose_q, problem.pose_q)
    np.testing.assert_allclose(back.landmarks, problem.landmarks)
    if kind != "mixed":
        assert back.kind == kind
        np.testing.assert_allclose(back.meas, problem.meas)
        np.testing.assert_array_equal(back.pose_idx, problem.pose_idx)
        np.testing.assert_array_equal(back.lm_idx, problem.lm_idx)


def test_read_graph_matches_the_jax_reader(tmp_path):
    """read_graph builds the JAX reader's sets: the same ids, fixed flags,
    estimates, edges and camera."""
    poses, landmarks, edge_sets, cam = opencv_json.read_graph(FIXTURE)
    jposes, jlandmarks, jedge_sets, jcam = jio.read_graph(FIXTURE)
    assert cam.to_vec().tolist() == jcam.to_vec().tolist()
    for vs, jvs in ((poses, jposes), (landmarks, jlandmarks)):
        assert list(vs._vertices) == list(jvs._vertices)
        for vid, v in vs._vertices.items():
            jv = jvs.get_vertex(vid)
            assert v.fixed == jv.fixed
            est, jest = v.estimate, jv.estimate
            if isinstance(est, tba.Se3):
                est, jest = np.concatenate([est.q, est.t]), np.concatenate([jest.q, jest.t])
            np.testing.assert_array_equal(est, jest)
    assert [es.KIND for es in edge_sets] == [es.KIND for es in jedge_sets] == ["mono", "stereo"]
    for es, jes in zip(edge_sets, jedge_sets):
        assert es.nedges() == jes.nedges()
        for e, je in zip(es.edges, jes.edges):
            assert [v.id for v in e.vertices] == [v.id for v in je.vertices]
            np.testing.assert_array_equal(e.measurement, je.measurement)
            assert e.information == je.information

    with pytest.raises(NotImplementedError, match="BAProblem"):
        opencv_json.write_graph(str(tmp_path / "g.json"), pose_set=poses, landmark_set=landmarks,
                                edge_sets=edge_sets)


def test_object_graph_load_and_optimize(tmp_path):
    """A stereo graph file through read_graph (objects) and read_problem
    (arrays): the same packed arrays, so the same trace at rtol 1e-9 and in
    fact bit for bit, and the estimates written back."""
    problem = make_ba_problem(num_poses=6, num_landmarks=30, kind="stereo", seed=47)
    path = str(tmp_path / "graph.json")
    opencv_json.write_graph(path, problem=problem)

    opt = _graph_optimizer(path)
    assert opt.n_vertices(0) == 6 and len(opt.get_edge_sets()) == 1
    opt.optimize(3)
    arr = optimizer_from_problem(opencv_json.read_problem(path), device="cpu")
    arr.optimize(3)
    np.testing.assert_allclose(_trace(opt), _trace(arr), rtol=1e-9)
    assert _trace(opt) == _trace(arr)
    q, _ = arr.solver.result_poses()
    got = np.stack([opt.vertex_sets[0].get_vertex(i).estimate.q for i in range(6)])
    np.testing.assert_array_equal(got, q)


def _jax_fixture_trace(reader):
    """The JAX package's trace of the fixture through the same reader."""
    if reader == "read_problem":
        opt = joptimizer_from_problem(jio.read_problem(FIXTURE))
    else:
        poses, landmarks, edge_sets, _ = jio.read_graph(FIXTURE)
        opt = jba.TpuGraphOptimisation.create(
            jba.GraphOptimisationOptions(per_edge_information=True))
        opt.add_vertex_set(poses)
        opt.add_vertex_set(landmarks)
        for es in edge_sets:
            opt.add_edge_set(es)
        opt.initialize()
    opt.optimize(10)
    return _trace(opt)


@pytest.mark.parametrize("reader", ["read_problem", "read_graph"])
def test_golden_mixed_fixture_trace(reader):
    """The committed mono + stereo fixture through either reader, merged into
    one masked stereo set, reproduces the oracle's trace at rtol 1e-6 and the
    JAX package's trace through the same reader at rtol 1e-9."""
    if reader == "read_problem":
        problem = opencv_json.read_problem(FIXTURE)
        assert len(problem.specs) == 2
        opt = optimizer_from_problem(problem, device="cpu")
    else:
        opt = _graph_optimizer(FIXTURE)
    assert opt.solver.packed.mask3 is not None
    opt.optimize(10)
    got = _trace(opt)
    assert len(got) == len(GOLDEN_MIXED_TRACE)
    np.testing.assert_allclose(got, GOLDEN_MIXED_TRACE, rtol=1e-6)
    np.testing.assert_allclose(got, _jax_fixture_trace(reader), rtol=1e-9)


def test_sample_ba_from_file_runs_on_the_cpu(capsys):
    assert sample_ba_from_file.main([FIXTURE, "10", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "num edges      : 646" in out
    chi2 = [float(line.split("chi2=")[1]) for line in out.splitlines() if "chi2=" in line]
    np.testing.assert_allclose(chi2, GOLDEN_MIXED_TRACE, atol=0.05)
    assert "0: Initialize Optimizer" in out


def test_sample_comparison_with_cpu_prints_parity(capsys):
    assert sample_comparison_with_cpu.main([FIXTURE, "10", "--device", "cpu"]) == 0
    assert "PARITY: OK" in capsys.readouterr().out
