"""Train and pack a tree vocabulary from rendered frames (counterpart of
tools/make_vocab.py, with its defaults).

    python -m my_orb_slam2_tpu_torch.make_vocab [--frames 96] [--k 10] [--depth 4]
        [--iters 6] [--out PATH] [--device cuda|cpu]

Renders `--frames` 640x480 views, 12 of each of `make_world(seed=100 + w)`
at `pose_for_view(i, phase=0.777 * seed)` (the tool's `render_frame`),
extracts their ORB descriptors at 1000 features through the batch
front-end (`parallel/dist_frontend.make_batch_extractor` on a lone rank:
one FAST+NMS launch over each world's (12, atlas_h, atlas_w) batch on
the card), trains the k-medians tree on the device
(`ops/bow.train_tree_vocabulary`, seed 0) and writes it as a packed npz,
by default `my_orb_slam2_tpu_torch/build/orbvoc_k{k}_L{depth}.npz` (the
JAX package's assets stay as they are). Then it prints the distinct
words of a held-out frame (world 999, view 0), as the tool does.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

H, W = 480, 640
FRAMES_PER_WORLD = 12
BUILD_DIR = Path(__file__).resolve().parent / "build"


def mono_config():
    """tools/make_vocab.py's camera: a 640x480 pinhole at f = 500, 1000
    ORB features."""
    from my_orb_slam2_tpu_torch.utils.config import CameraConfig, OrbConfig, Sensor, SlamConfig

    return SlamConfig(
        sensor=Sensor.MONOCULAR,
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=0.0, th_depth=40.0, width=W, height=H),
        orb=OrbConfig(n_features=1000),
    )


def render_frame(world, cam, view: int) -> np.ndarray:
    """tools/render_world.render_frame: view `view` of `world`."""
    from my_orb_slam2_tpu_torch.utils.synthetic import pose_for_view, render_view

    return render_view(world, cam, H, W, pose_for_view(view, phase=world.seed * 0.777))


def corpus_from_frames(extractor, n_frames: int) -> tuple:
    """(corpus (N, 8) uint32, frames used, FAST+NMS launches): every valid
    descriptor of each rendered frame, in frame order."""
    from my_orb_slam2_tpu_torch.ops import fast_nms
    from my_orb_slam2_tpu_torch.parallel.dist_frontend import make_batch_extractor
    from my_orb_slam2_tpu_torch.parallel.group import local_group
    from my_orb_slam2_tpu_torch.utils.synthetic import make_world

    run = make_batch_extractor(local_group(extractor.pattern.device), extractor)
    cam = mono_config().camera
    descs = []
    launches = fast_nms.fast_nms.launches
    for w in range(max(n_frames // FRAMES_PER_WORLD, 1)):
        world = make_world(seed=100 + w)
        n = min(FRAMES_PER_WORLD, n_frames - w * FRAMES_PER_WORLD)
        kps = run(np.stack([render_frame(world, cam, i) for i in range(n)]))
        desc, valid = kps.desc.cpu().numpy(), kps.valid.cpu().numpy()
        descs += [desc[b][valid[b]] for b in range(n)]
    corpus = np.ascontiguousarray(np.concatenate(descs)).view(np.uint32)
    return corpus, len(descs), fast_nms.fast_nms.launches - launches


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from my_orb_slam2_tpu_torch.ops.bow import train_tree_vocabulary
    from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
    from my_orb_slam2_tpu_torch.utils import vocab_io
    from my_orb_slam2_tpu_torch.utils.synthetic import make_world

    dev = torch.device(args.device)
    cfg = mono_config()
    ex = OrbExtractor(cfg.orb, H, W, device=dev)
    t0 = time.perf_counter()
    corpus, n_frames, launches = corpus_from_frames(ex, args.frames)
    extract_s = time.perf_counter() - t0
    n_worlds = max(args.frames // FRAMES_PER_WORLD, 1)
    print(f"corpus: {corpus.shape[0]} descriptors from {n_frames} rendered frames across {n_worlds} worlds "
          f"({extract_s:.1f}s, {launches} FAST+NMS launches)")

    t0 = time.perf_counter()
    voc = train_tree_vocabulary(corpus, k=args.k, depth=args.depth, iters=args.iters, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    print(f"trained k={args.k} L={args.depth} -> {voc.n_words} words ({train_s:.1f}s)")

    out = Path(args.out or BUILD_DIR / f"orbvoc_k{args.k}_L{args.depth}.npz")
    out.parent.mkdir(parents=True, exist_ok=True)
    vocab_io.save_packed(voc, str(out))
    print(f"packed -> {out} ({out.stat().st_size / 1024:.0f} KB)")

    kps, _ = ex(torch.as_tensor(render_frame(make_world(seed=999), cfg.camera, 0)).to(dev))
    words = voc.words(kps.desc)[kps.valid]
    distinct = int(torch.unique(words).numel())
    print(f"held-out frame: {distinct} distinct words / {words.numel()} keypoints")
    return {"vocabulary": voc, "corpus": corpus, "frames": n_frames, "corpus_launches": launches,
            "extract_s": extract_s, "train_s": train_s, "path": str(out), "held_out_words": distinct,
            "held_out_keypoints": int(words.numel())}


if __name__ == "__main__":
    main()
