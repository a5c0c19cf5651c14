"""The sharded solvers, JAX reference vs PyTorch port, on the CPU:
`parallel/group.py`, `dist_ba.py` (both layouts), `dist_pose_graph.py`,
`dist_frontend.py` and the `dist_fake_cluster` harness.

The port runs as D = 4 gloo processes (`tests/_torch_dist_worker.py`,
spawned once for the module), the reference on a 4-device sub-mesh of
conftest's 8 CPU devices, both on tests/test_dist_ba.py's inputs:
`make_ba_problem(rng, 6, 200)` observation-sharded, `(16, 300)`
camera-sharded, the 16-keyframe ring for the pose graph, 8 images of
96x128 for the front-end. World 1 runs in this process too (a lone rank:
identity collectives, the same solver code).

Tolerances: against the reference's sharded solvers, the single-device
parity tests' own (tests/test_torch_loop_closing.py): cameras 1e-4 and
points 1e-3, the pose graph 1e-4; against the port's single-device
solvers, tests/test_dist_ba.py's: 5e-3 on cameras, a 5e-3 median on
points, 2e-3 on the pose graph, and every free camera within 0.02 of the
truth. The batch front-end equals the port's single-device extractor
exactly and the reference's by tests/test_torch_frontend.py's keypoint-set
criteria (the atlases differ by the resize's summation order)."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from my_orb_slam2_tpu.ops import ba as jba
from my_orb_slam2_tpu.ops import lie as jlie
from my_orb_slam2_tpu.ops.frontend import OrbExtractor as JOrbExtractor
from my_orb_slam2_tpu.parallel import dist_ba as jdba
from my_orb_slam2_tpu.parallel import dist_pose_graph as jdpg
from my_orb_slam2_tpu.parallel.dist_frontend import make_batch_extractor as jmake_batch_extractor
from my_orb_slam2_tpu.utils.config import OrbConfig as JOrbConfig
from my_orb_slam2_tpu_torch import dist_fake_cluster as tfc
from my_orb_slam2_tpu_torch.ops import ba as tba
from my_orb_slam2_tpu_torch.ops import fast_nms as tfast
from my_orb_slam2_tpu_torch.ops import lie as tlie
from my_orb_slam2_tpu_torch.ops import pose_graph as tpg
from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor as TOrbExtractor
from my_orb_slam2_tpu_torch.parallel import dist_ba as tdba
from my_orb_slam2_tpu_torch.parallel import dist_pose_graph as tdpg
from my_orb_slam2_tpu_torch.parallel import group as tgroup
from my_orb_slam2_tpu_torch.parallel.dist_frontend import make_batch_extractor
from my_orb_slam2_tpu_torch.utils.bridge import flat_ba_problem_from_numpy
from my_orb_slam2_tpu_torch.utils.config import OrbConfig as TOrbConfig
from tests import _torch_dist_worker as worker
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.test_optim import BF, CX, CY, FX, FY, make_ba_problem
from tests.test_torch_frontend import KP_OVERLAP, _kp_set
from tools import dist_fake_cluster as jfc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 4
CAM_TOL, PT_TOL, PG_TOL = 1e-4, 1e-3, 1e-4  # vs the reference's sharded solvers
SINGLE_CAM_TOL, SINGLE_PT_MEDIAN, SINGLE_PG_TOL = 5e-3, 5e-3, 2e-3  # vs the port's single-device solvers
TRUTH_TOL = 0.02
FE_HW = (96, 128)


def _np_fields(prob):
    return {n: np.asarray(getattr(prob, n)) for n in jba.BAProblem._fields}


def _ring(rng, KF=16):
    """tests/test_dist_ba.py's 16-keyframe drifted ring with one loop edge."""
    gt = []
    T = np.eye(4)
    step = np.asarray(jlie.se3_exp(jnp.asarray([0.0, 0.0, 0.5, 0.0, 2 * np.pi / KF, 0.0])))
    for _ in range(KF):
        gt.append(np.linalg.inv(T))
        T = T @ np.linalg.inv(step)
    gt = np.stack(gt)
    est = [gt[0]]
    for k in range(1, KF):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        noise = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01)))
        est.append(rel @ noise @ est[k - 1])
    est = np.stack(est)
    ei = list(range(KF - 1)) + [KF - 1]
    ej = list(range(1, KF)) + [0]
    meas = [(est[b] @ np.linalg.inv(est[a])) if b == a + 1 else (gt[b] @ np.linalg.inv(gt[a])) for a, b in zip(ei, ej)]
    return (est.astype(np.float32), np.ones(KF, bool), np.arange(KF) == 0, np.asarray(ei, np.int32),
            np.asarray(ej, np.int32), np.stack(meas).astype(np.float32), np.ones(len(ei), bool))


def _fe_images():
    """tests/test_dist_ba.py:110-142's 8 noise images with blobs."""
    H, W = FE_HW
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(8, H, W)).astype(np.uint8)
    for b in range(8):
        for _ in range(30):
            y, x = rng.integers(10, H - 10), rng.integers(10, W - 10)
            imgs[b, y - 2 : y + 3, x - 2 : x + 3] = rng.integers(0, 255)
    return imgs


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:D]), (axis,))


def _jax_runs(inputs):
    """The reference's sharded solvers at D = 4."""
    obs = jba.BAProblem(**{n: jnp.asarray(inputs[f"obs_{n}"]) for n in jba.BAProblem._fields})
    out_obs = jdba.make_distributed_ba(_mesh("obs"))(jdba.pad_problem_for_mesh(obs, D), FX, FY, CX, CY, BF,
                                                     n_iters=8, cg_iters=32)
    cam = jba.BAProblem(**{n: jnp.asarray(inputs[f"cam_{n}"]) for n in jba.BAProblem._fields})
    cam_p, _ = jdba.partition_by_camera(cam, D)
    out_cam = jdba.make_camera_sharded_ba(_mesh("kf"))(cam_p, FX, FY, CX, CY, BF, n_iters=8, cg_iters=48)
    pg = [jnp.asarray(inputs[f"pg_{n}"]) for n in worker.PG_ARGS]
    out_pg = jdpg.make_distributed_pose_graph(_mesh("edges"))(*pg[:3], *jdpg.pad_edges_for_mesh(*pg[3:], D),
                                                              n_iters=15, fix_scale=True)
    ex = JOrbExtractor(JOrbConfig(n_features=64, n_levels=3), *FE_HW)
    kps = jmake_batch_extractor(_mesh("batch"), ex)(jnp.asarray(inputs["fe_images"]))
    return {
        "obs_cam": np.asarray(out_obs.cam_Tcw), "obs_pt": np.asarray(out_obs.pt_pos),
        "cam_cam": np.asarray(out_cam.cam_Tcw), "cam_pt": np.asarray(out_cam.pt_pos), "pg": np.asarray(out_pg),
        "fe_uv_level": np.asarray(kps.uv_level), "fe_octave": np.asarray(kps.octave), "fe_valid": np.asarray(kps.valid),
    }


def _port_single(inputs):
    """The port's single-device solvers on the same padded problems."""
    obs_p = tdba.pad_problem_for_mesh(worker.problem(inputs, "obs"), D)
    obs = tba.bundle_adjust(flat_ba_problem_from_numpy(obs_p, "cpu"), FX, FY, CX, CY, BF, n_iters=8, cg_iters=32)
    cam_p, _ = tdba.partition_by_camera(worker.problem(inputs, "cam"), D)
    cam = tba.bundle_adjust(flat_ba_problem_from_numpy(cam_p, "cpu"), FX, FY, CX, CY, BF, n_iters=8, cg_iters=48)
    pg = tpg.optimize_pose_graph(*(torch.tensor(inputs[f"pg_{n}"]) for n in worker.PG_ARGS), n_iters=15,
                                 fix_scale=True)
    return {"obs_cam": obs.cam_Tcw.numpy(), "obs_pt": obs.pt_pos.numpy(), "cam_cam": cam.cam_Tcw.numpy(),
            "cam_pt": cam.pt_pos.numpy(), "pg": pg.numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs; the D = 4 gloo cluster (started first, so it runs while
    the reference compiles); the reference's outputs; the port's
    single-device and world-1 outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    obs, obs_truth, _ = make_ba_problem(np.random.default_rng(0), n_cams=6, n_pts=200)
    cam, cam_truth, _ = make_ba_problem(np.random.default_rng(0), n_cams=16, n_pts=300)
    inputs = {f"obs_{n}": v for n, v in _np_fields(obs).items()}
    inputs.update({f"cam_{n}": v for n, v in _np_fields(cam).items()})
    inputs.update({f"pg_{n}": v for n, v in zip(worker.PG_ARGS, _ring(np.random.default_rng(0)))})
    inputs["fe_images"] = _fe_images()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "tests._torch_dist_worker", "--world", str(D), "--init-method",
           (tmp / "rendezvous").as_uri(), "--inputs", str(tmp / "inputs.npz"), "--out", str(tmp)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(D)]
    try:
        ref = _jax_runs(inputs)
        single = _port_single(inputs)
        world1 = {k: v.numpy() for k, v in worker.solve_all(tgroup.local_group("cpu"), inputs).items()}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(D)]
    truth = {"obs": obs_truth, "cam": cam_truth}
    return {"inputs": inputs, "ref": ref, "single": single, "ranks": ranks, "world1": world1, "truth": truth}


# -- layouts ------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [3, 4, 8])
def test_pad_problem_for_mesh_matches_reference(n_shards):
    prob, _, _ = make_ba_problem(np.random.default_rng(1), n_cams=5, n_pts=120)
    prob = prob._replace(**{n: getattr(prob, n)[:-7] for n in tdba._OBS})  # an observation count D does not divide
    got = tdba.pad_problem_for_mesh(prob, n_shards)
    want = _np_fields(jdba.pad_problem_for_mesh(prob, n_shards))
    for n, v in want.items():
        assert np.array_equal(np.asarray(getattr(got, n)), v) and getattr(got, n).dtype == v.dtype, n


@pytest.mark.parametrize("n_shards", [3, 4, 8])
def test_partition_by_camera_matches_reference(n_shards):
    prob, _, _ = make_ba_problem(np.random.default_rng(2), n_cams=10, n_pts=150)
    got, Cd = tdba.partition_by_camera(prob, n_shards)
    want, Cd_j = jdba.partition_by_camera(prob, n_shards)
    assert Cd == Cd_j
    for n, v in _np_fields(want).items():
        assert np.array_equal(getattr(got, n), v) and getattr(got, n).dtype == v.dtype, n


@pytest.mark.parametrize("n_shards", [3, 4])
def test_pad_edges_for_mesh_matches_reference(n_shards):
    edges = _ring(np.random.default_rng(3))[3:]
    got = tdpg.pad_edges_for_mesh(*edges, n_shards)
    want = jdpg.pad_edges_for_mesh(*(jnp.asarray(x) for x in edges), n_shards)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w)) and g.dtype == np.asarray(w).dtype


def test_fake_cluster_ba_problem_matches_tool():
    got, want = tfc.build_problem(16, 300, 0), jfc.build_problem(16, 300, 0)
    for n in ("obs_cam", "obs_pt", "obs_mask", "cam_fixed", "pt_valid"):
        assert np.array_equal(getattr(got, n), getattr(want, n)), n
    for n in ("cam_Tcw", "pt_pos", "obs_uv", "obs_ur", "obs_inv_sigma2"):
        np.testing.assert_allclose(getattr(got, n), getattr(want, n), rtol=1e-6, atol=1e-6, err_msg=n)


def test_fake_cluster_pg_problem_matches_tool():
    got, want = tfc.build_pg_problem(16), jfc.build_pg_problem(16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype.kind in "bi":
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# -- the solvers --------------------------------------------------------------


def _dist_outputs(runs, world):
    return runs["world1"] if world == 1 else runs["ranks"][0]


@pytest.mark.parametrize("solver", ["obs", "cam"])
def test_ba_matches_reference_sharded(runs, solver):
    got, ref = runs["ranks"][0], runs["ref"]
    np.testing.assert_allclose(got[f"{solver}_cam"], ref[f"{solver}_cam"], rtol=0, atol=CAM_TOL)
    np.testing.assert_allclose(got[f"{solver}_pt"], ref[f"{solver}_pt"], rtol=0, atol=PT_TOL)


def test_pose_graph_matches_reference_sharded(runs):
    np.testing.assert_allclose(runs["ranks"][0]["pg"], runs["ref"]["pg"], rtol=0, atol=PG_TOL)


@pytest.mark.parametrize("world", [1, D])
@pytest.mark.parametrize("solver", ["obs", "cam"])
def test_ba_matches_single_device(runs, solver, world):
    got, single = _dist_outputs(runs, world), runs["single"]
    C = runs["truth"][solver].shape[0]
    cams = got[f"{solver}_cam"][:C]
    np.testing.assert_allclose(cams, single[f"{solver}_cam"][:C], rtol=0, atol=SINGLE_CAM_TOL)
    assert np.median(np.linalg.norm(got[f"{solver}_pt"] - single[f"{solver}_pt"], axis=1)) < SINGLE_PT_MEDIAN
    for c in range(2, C):  # ... and it solved the problem
        d = tlie.se3_log(torch.tensor(cams[c] @ np.linalg.inv(runs["truth"][solver][c]), dtype=torch.float32))
        assert float(torch.linalg.norm(d)) < TRUTH_TOL, (c, d)


@pytest.mark.parametrize("world", [1, D])
def test_pose_graph_matches_single_device(runs, world):
    np.testing.assert_allclose(_dist_outputs(runs, world)["pg"], runs["single"]["pg"], rtol=0, atol=SINGLE_PG_TOL)


def test_replicated_outputs_bit_identical(runs):
    """Points (both layouts), observation-sharded cameras, the pose graph
    and the gathered keypoints are the same bits on every rank; each
    rank's camera block is its slice of the gathered cameras."""
    r0 = runs["ranks"][0]
    for r, out in enumerate(runs["ranks"]):
        for k in ("obs_cam", "obs_pt", "cam_pt", "cam_cam", "pg", "fe_uv", "fe_desc", "fe_valid", "n_all_reduce"):
            assert np.array_equal(out[k], r0[k]), (r, k)
        Cd = out["cam_local"].shape[0]
        assert np.array_equal(out["cam_local"], r0["cam_cam"][r * Cd : (r + 1) * Cd])


def test_collectives_exact(runs):
    for r, out in enumerate(runs["ranks"]):
        assert np.array_equal(out["psum"], [10.0, -3.0])
        assert np.array_equal(out["gather_f32"], np.repeat(np.arange(D) - 1.5, 2)[:, None] * np.ones((1, 3)))
        assert np.array_equal(out["gather_i32"], [[-(2 ** 31) + q, q] for q in range(D)])
        assert out["gather_bool"].dtype == bool
        assert np.array_equal(out["gather_bool"], [[q % 2 == 0, True, False] for q in range(D)])


# -- the batch front-end ---------------------------------------------------------


def test_batch_frontend_equals_single_device(runs):
    imgs = runs["inputs"]["fe_images"]
    ex = TOrbExtractor(TOrbConfig(n_features=64, n_levels=3), *FE_HW, device="cpu")
    for out in (runs["ranks"][0], runs["world1"]):
        for b in range(imgs.shape[0]):
            ref, _ = ex(torch.tensor(imgs[b]))
            for f in ("uv", "valid", "desc", "octave", "uv_level"):
                assert np.array_equal(out[f"fe_{f}"][b], getattr(ref, f).numpy()), (b, f)


def test_batch_frontend_matches_reference(runs):
    got, ref = runs["ranks"][0], runs["ref"]
    for b in range(ref["fe_valid"].shape[0]):
        args_j = (ref["fe_uv_level"][b], ref["fe_octave"][b], ref["fe_valid"][b])
        args_t = (got["fe_uv_level"][b], got["fe_octave"][b], got["fe_valid"][b])
        assert args_j[2].sum() == args_t[2].sum()
        assert _kp_set(*args_j, level=0) == _kp_set(*args_t, level=0)
        sj, st = _kp_set(*args_j), _kp_set(*args_t)
        assert len(sj & st) >= KP_OVERLAP * len(sj)


def test_batch_frontend_needs_divisible_batch():
    ex = TOrbExtractor(TOrbConfig(n_features=64, n_levels=3), *FE_HW, device="cpu")
    group = tgroup.Group(1, 3, "cpu", "gloo")  # never reduces: the check comes first
    with pytest.raises(ValueError, match="does not split"):
        make_batch_extractor(group, ex)(np.zeros((4, *FE_HW), np.uint8))


def test_batch_extractor_off_cpu_never_takes_plain_path(monkeypatch):
    """A batch on any device but the CPU goes to the kernel's launcher
    (which raises here, off the card), never to the plain FAST path."""
    ex = TOrbExtractor(TOrbConfig(n_features=64, n_levels=3), *FE_HW, device="cpu")

    def plain(*_):
        raise AssertionError("the plain FAST path ran for a non-CPU batch")

    monkeypatch.setattr(tfast, "fast_score_map", plain)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ex.fast_scores(torch.zeros((2, ex.atlas_h, ex.atlas_w), device="meta"))


# -- groups and the harness --------------------------------------------------------


def test_init_group_never_falls_back_to_gloo(tmp_path):
    """NCCL without CUDA raises (no process group starts); so does a CUDA
    rank on a machine without a card, and an unknown backend."""
    init = (tmp_path / "rendezvous").as_uri()
    with pytest.raises((RuntimeError, ValueError), match="NCCL"):
        tgroup.init_group("nccl", 0, 1, init, "cpu")
    with pytest.raises((RuntimeError, ValueError)):
        tgroup.init_group("nccl", 0, 1, init, "cuda")
    with pytest.raises(ValueError, match="backend"):
        tgroup.init_group("mpi", 0, 1, init, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgroup.init_group("gloo", 0, 1, init, "cuda")
    assert not torch.distributed.is_initialized()


def test_fake_cluster_pose_graph_cli(tmp_path):
    out = tmp_path / "cluster.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "my_orb_slam2_tpu_torch.dist_fake_cluster", "--device", "cpu", "--backend", "gloo",
         "--sizes", "1,2", "--kind", "pg", "--kfs", "64", "--json", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    runs = json.loads(out.read_text())["runs"]
    assert [(r["kind"], r["procs"]) for r in runs] == [("pg", 1), ("pg", 2)]
    for r in runs:
        assert r["ok"] and r["replicated_bit_identical"] and r["rel_err_vs_single"] < 1e-3
        assert r["n_edges"] == 107 and r["all_reduces_per_step"] == 68  # H, b, 64 matvecs, 2 costs
