"""Host I/O and the dataset runner (utils/png_io.py, utils/native_io.py,
utils/datasets.py, utils/synthetic.make_tum, run_dataset.py), JAX
reference vs PyTorch port, on the CPU; and the guard that the port imports
nothing of jax or of the JAX package.

- PNG round trip: the port's encoder writes the reference encoder's bytes,
  and the native decoder (built by the port into its own build directory)
  reads 8- and 16-bit images back exactly, alone and through the
  prefetcher. Skipped only where there is no g++.
- A tiny TUM sequence: the port's writer and tools/make_dataset.make_tum
  write the same files (PNG bytes, lists and settings identical, ground
  truth to 2e-6); both packages' `TumMonoDataset` / `TumRgbdDataset` read
  the port's sequence to identical arrays and timestamps, the port's also
  without OpenCV (the native decoder, as on the card's machine).
- `run_dataset.main` on the CPU (tum-mono and tum-rgbd) writes both
  trajectory files; the RGB-D run tracks every frame.
- The stereo sequences: `make_kitti` / `make_euroc` write the tools' files
  byte for byte, and at a published camera (KITTI 00-02, EuRoC) settings
  that load as that camera; `pose_for_view` / `render_stereo` give
  tools/render_world's poses (to f32 rounding) and images.
- `run_dataset.main kitti` / `euroc` on the CPU with `--viz` and `--live`
  write the TUM and KITTI trajectories and the PNGs; `synthetic_drive` and
  `ar_demo` meet their gates on the CPU at fewer frames.
- In a subprocess with `sys.modules["jax"] = None`, every module of the
  port and chip_smoke.py import, print nothing (importing an entry point
  drives nothing), and no module of the JAX package is loaded."""

import filecmp
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest

from my_orb_slam2_tpu.utils import datasets as jds
from my_orb_slam2_tpu.utils.png_io import encode_png as j_encode_png
from my_orb_slam2_tpu_torch import ar_demo, run_dataset, synthetic_drive
from my_orb_slam2_tpu_torch.utils import synthetic as syn
from my_orb_slam2_tpu_torch.utils import datasets as tds
from my_orb_slam2_tpu_torch.utils import native_io
from my_orb_slam2_tpu_torch.utils.png_io import encode_png, write_png
from my_orb_slam2_tpu_torch.utils.synthetic import make_tum
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SEQ, H_SEQ, W_SEQ = 4, 96, 128


def test_png_roundtrip_native_decoder(tmp_path):
    rng = np.random.default_rng(0)
    g8 = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    g16 = rng.integers(0, 65536, (41, 29)).astype(np.uint16)
    rgb = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    for img in (g8, g16, rgb):
        assert encode_png(img) == j_encode_png(img)
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native decoder cannot be built here")
    assert native_io.available()
    assert native_io.library_path().parent == native_io.BUILD_DIR
    p8, p16 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(p8, g8)
    write_png(p16, g16)
    assert np.array_equal(native_io.decode_image(p8), g8)
    d16 = native_io.decode_image(p16)
    assert d16.dtype == np.uint16 and np.array_equal(d16, g16)
    assert native_io.decode_image(str(tmp_path / "missing.png")) is None
    pf = native_io.NativePrefetcher([p8, p16], n_threads=1, window=2)
    assert np.array_equal(pf.get(0), g8) and np.array_equal(pf.get(1), g16)
    pf.close()


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    from tools.make_dataset import make_tum as j_make_tum

    root = tmp_path_factory.mktemp("tum")
    port, ref = str(root / "port"), str(root / "ref")
    poses, times = make_tum(port, n_frames=N_SEQ, H=H_SEQ, W=W_SEQ, lateral=0.12, extent=(5.0, 3.5, 10.0), z_near=1.5)
    j_poses, j_times = j_make_tum(ref, n_frames=N_SEQ, H=H_SEQ, W=W_SEQ, lateral=0.12, extent=(5.0, 3.5, 10.0),
                                  z_near=1.5)
    return {"port": port, "ref": ref, "poses": poses, "times": times, "j_poses": j_poses, "j_times": j_times}


def test_make_tum_writes_the_tools_sequence(sequences):
    port, ref = sequences["port"], sequences["ref"]
    assert sequences["times"] == sequences["j_times"]
    np.testing.assert_allclose(np.stack(sequences["poses"]), np.stack(sequences["j_poses"]), rtol=0, atol=1e-6)
    for sub in ("rgb", "depth"):
        names = sorted(os.listdir(os.path.join(ref, sub)))
        assert names == sorted(os.listdir(os.path.join(port, sub))) and len(names) == N_SEQ
        _, mismatch, errors = filecmp.cmpfiles(os.path.join(ref, sub), os.path.join(port, sub), names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)
    for name in ("rgb.txt", "depth.txt", "associations.txt", "settings.yaml"):
        assert filecmp.cmp(os.path.join(ref, name), os.path.join(port, name), shallow=False), name
    gt = [np.loadtxt(os.path.join(d, "groundtruth.txt")) for d in (port, ref)]
    np.testing.assert_allclose(gt[0], gt[1], rtol=0, atol=2e-6)


def test_tum_readers_agree(sequences, monkeypatch):
    seq = sequences["port"]
    got, want = list(tds.TumMonoDataset(seq).frames()), list(jds.TumMonoDataset(seq).frames())
    assert len(got) == len(want) == N_SEQ
    if shutil.which("g++") is not None:  # the card's machine has no OpenCV: the native decoder reads
        monkeypatch.setattr(tds, "_cv2", lambda: None)
        native = list(tds.TumMonoDataset(seq).frames())
        assert all(np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(native, got))
        monkeypatch.undo()
    for (img, ts), (img_j, ts_j), t in zip(got, want, sequences["times"]):
        assert img.dtype == img_j.dtype == np.uint8 and img.shape == (H_SEQ, W_SEQ)
        assert np.array_equal(img, img_j) and ts == ts_j == float(f"{t:.6f}")
    assoc = os.path.join(seq, "associations.txt")
    rgbd = list(zip(tds.TumRgbdDataset(seq, assoc).frames(), jds.TumRgbdDataset(seq, assoc).frames()))
    assert len(rgbd) == N_SEQ
    for (rgb, depth, ts), (rgb_j, depth_j, ts_j) in rgbd:
        assert depth.dtype == depth_j.dtype == np.uint16
        assert np.array_equal(rgb, rgb_j) and np.array_equal(depth, depth_j) and ts == ts_j


def test_run_dataset_writes_trajectories(sequences, tmp_path):
    seq = sequences["port"]
    text = open(os.path.join(seq, "settings.yaml")).read()
    # The 96x128 views hold too few depth keypoints for the written
    # 250-point RGB-D initialization gate: the RGB-D run lowers it.
    (tmp_path / "rgbd.yaml").write_text(text.replace("Tracking.minStereoInitPoints: 250", "Tracking.minStereoInitPoints: 30"))
    for kind in ("tum-mono", "tum-rgbd"):
        out = tmp_path / kind
        settings = os.path.join(seq, "settings.yaml") if kind == "tum-mono" else str(tmp_path / "rgbd.yaml")
        res = run_dataset.main([kind, seq, settings, "--device", "cpu", "--max-frames", "3", "--out-dir", str(out)])
        assert len(res["infos"]) == len(res["times"]) == 3
        for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
            assert (out / name).exists(), (kind, name)
    rows = np.atleast_2d(np.loadtxt(tmp_path / "tum-rgbd" / "CameraTrajectory.txt"))
    assert rows.shape == (3, 8) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [float(f"{t:.6f}") for t in sequences["times"][:3]])


def test_port_imports_nothing_of_jax():
    code = (
        "import sys, pkgutil, importlib, subprocess, multiprocessing\n"
        "sys.modules['jax'] = None\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('importing started a process')\n"
        "subprocess.Popen.__init__ = refuse\n"
        "multiprocessing.Process.start = refuse\n"
        "import my_orb_slam2_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'my_orb_slam2_tpu' or m.startswith('my_orb_slam2_tpu.'))\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing started a process group'\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout) >= 48  # the count is all it prints: importing drove nothing
    names = [m.name for m in pkgutil.walk_packages(["my_orb_slam2_tpu_torch"], "my_orb_slam2_tpu_torch.")]
    for mod in ("run_stream", "synthetic_drive", "ar_demo", "utils.stream", "utils.viz", "utils.ar", "utils.profiling",
                "parallel.group", "parallel.dist_ba", "parallel.dist_pose_graph", "parallel.dist_frontend",
                "dist_fake_cluster", "make_vocab"):
        assert f"my_orb_slam2_tpu_torch.{mod}" in names, mod


@pytest.mark.parametrize("kind", ["kitti", "euroc"])
def test_stereo_sequence_writers(kind, tmp_path):
    from tools import make_dataset

    port, ref = tmp_path / "port", tmp_path / "ref"
    make = {"kitti": (syn.make_kitti, make_dataset.make_kitti), "euroc": (syn.make_euroc, make_dataset.make_euroc)}[kind]
    poses, times = make[0](str(port), 3, H_SEQ, W_SEQ)
    j_poses, j_times = make[1](str(ref), 3, H_SEQ, W_SEQ)
    assert times == j_times
    np.testing.assert_allclose(np.stack(poses), np.stack(j_poses), rtol=0, atol=1e-6)
    files = sorted(str(p.relative_to(ref)) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(port)) for p in port.rglob("*") if p.is_file()) and len(files) == 9
    for f in files:
        if f != "groundtruth.txt":
            assert filecmp.cmp(ref / f, port / f, shallow=False), f
    gt = [np.loadtxt(d / "groundtruth.txt") for d in (port, ref)]
    np.testing.assert_allclose(gt[0], gt[1], rtol=0, atol=2e-6)

    from my_orb_slam2_tpu_torch.utils.config import Sensor, load_yaml_settings

    pub = {"kitti": syn.KITTI_00_02, "euroc": syn.EUROC}[kind]
    make[0](str(tmp_path / "pub"), 1, published=pub)
    cfg = load_yaml_settings(str(tmp_path / "pub" / "settings.yaml"), Sensor.STEREO)
    c = cfg.camera
    assert (c.width, c.height, c.fx, c.fy, c.cx, c.cy, c.bf, c.th_depth, c.fps) == (
        pub.W, pub.H, pub.cam.fx, pub.cam.fy, pub.cam.cx, pub.cam.cy, pub.cam.bf, pub.th_depth, pub.fps)
    assert (cfg.orb.n_features, cfg.orb.n_levels, cfg.orb.scale_factor, cfg.orb.ini_th_fast,
            cfg.orb.min_th_fast) == (pub.n_features, 8, 1.2, 20, 7)
    left = native_io.decode_image(str(next((tmp_path / "pub").rglob("*.png")))) if native_io.available() else None
    assert left is None or left.shape == (pub.H, pub.W)


def test_views_match_render_world():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import render_world
    from tools.make_dataset import _Cam

    world, j_world = syn.make_world(seed=3, n_pts=700), render_world.make_world(seed=3, n_pts=700)
    cam, j_cam = syn.tum_camera(96, 128, 0.12), _Cam(96, 128, baseline=0.12)
    for view in range(0, 30, 3):
        Tcw = syn.pose_for_view(view, step=0.12, phase=3 * 0.777)
        np.testing.assert_allclose(Tcw, render_world.pose_for_view(view, step=0.12, phase=3 * 0.777), rtol=0, atol=1e-5)
        got, want = syn.render_stereo(world, cam, 96, 128, Tcw), render_world.render_stereo(j_world, j_cam, 96, 128, Tcw)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert np.array_equal(syn.render_view(world, cam, 96, 128, Tcw), want[0])


@pytest.mark.parametrize("kind", ["kitti", "euroc"])
def test_run_dataset_stereo_drivers(kind, tmp_path):
    seq, n = tmp_path / "seq", 6
    if kind == "kitti":
        syn.make_kitti(str(seq), n, 240, 320)
        paths = [str(seq), str(seq / "settings.yaml")]
    else:
        syn.make_euroc(str(seq), n, 240, 320)
        paths = [str(seq / "cam0" / "data"), str(seq / "cam1" / "data"), str(seq / "timestamps.txt"),
                 str(seq / "settings.yaml")]
    out, vdir, ldir = tmp_path / "out", tmp_path / "viz", tmp_path / "live"
    (ldir).mkdir()
    (ldir / "control").write_text("free\n")
    res = run_dataset.main([kind, *paths, "--device", "cpu", "--max-frames", str(n), "--out-dir", str(out),
                            "--viz", str(vdir), "--viz-every", "3", "--live", str(ldir)])
    assert len(res["infos"]) == n and res["commands"] == [(0, "free")]
    assert sum(info["state"] == 1 for info in res["infos"]) >= n - 3  # initialized, pipelined at depth 3
    rows = np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (n, 8) and np.isfinite(rows).all()
    if kind == "kitti":
        kitti = np.loadtxt(out / "CameraTrajectoryKITTI.txt", ndmin=2)
        assert kitti.shape == (n, 12) and np.isfinite(kitti).all()
    assert sorted(os.listdir(vdir)) == sorted(f"{k}_{i:06d}.png" for k in ("frame", "map", "map3d") for i in (0, 3))
    assert sorted(os.listdir(ldir)) == ["control", "live_frame.png", "live_map.png"]


def test_synthetic_drive_and_ar_demo(tmp_path):
    res = synthetic_drive.main(["--device", "cpu", "--frames", "20"])  # its gates raise SystemExit
    assert res["ate"] < synthetic_drive.ATE_GATE and res["mono_ok_from"] >= 0
    res = ar_demo.main(["--device", "cpu", "--frames", "12", "--out", str(tmp_path / "ar")])
    assert res["detected"] >= (12 - 2) // 2
    assert len(os.listdir(tmp_path / "ar")) == 10
