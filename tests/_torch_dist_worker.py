"""One gloo rank of tests/test_torch_parallel.py's cluster (CPU, no jax):

    python -m tests._torch_dist_worker --rank R --world D --init-method file:///... \
        --inputs problems.npz --out DIR

Runs the port's observation-sharded BA, camera-sharded BA, edge-sharded
pose graph and batch front-end on the inputs the test made, plus the
collectives on known values, and writes this rank's outputs to
DIR/rank{R}.npz."""

import argparse

import numpy as np
import torch

from my_orb_slam2_tpu_torch.ops.ba import BAProblem
from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
from my_orb_slam2_tpu_torch.parallel import dist_ba, dist_pose_graph as dpg
from my_orb_slam2_tpu_torch.parallel.dist_frontend import make_batch_extractor
from my_orb_slam2_tpu_torch.parallel.group import init_group
from my_orb_slam2_tpu_torch.utils.config import OrbConfig

FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 40.0  # tests/test_optim.py
PG_ARGS = ("S", "vvalid", "vfixed", "ei", "ej", "Sji", "emask")


def problem(d, prefix) -> BAProblem:
    return BAProblem(*[d[f"{prefix}_{n}"] for n in BAProblem._fields])


def solve_all(group, d) -> dict:
    """Every solver of the cluster on rank `group.rank`'s shard."""
    r, D, dev = group.rank, group.world, group.device
    out = {}
    obs = dist_ba.observation_shard(dist_ba.pad_problem_for_mesh(problem(d, "obs"), D), r, D, dev)
    res = dist_ba.make_distributed_ba(group)(obs, FX, FY, CX, CY, BF, n_iters=8, cg_iters=32)
    out["obs_cam"], out["obs_pt"] = res.cam_Tcw, res.pt_pos

    cam_p, _ = dist_ba.partition_by_camera(problem(d, "cam"), D)
    res = dist_ba.make_camera_sharded_ba(group)(dist_ba.camera_shard(cam_p, r, D, dev), FX, FY, CX, CY, BF,
                                                n_iters=8, cg_iters=48)
    out["cam_local"], out["cam_pt"] = res.cam_Tcw, res.pt_pos
    out["cam_cam"] = dist_ba.gather_cameras(group, res.cam_Tcw)

    S, vvalid, vfixed, ei, ej, Sji, emask = (d[f"pg_{n}"] for n in PG_ARGS)
    edges = dpg.edge_shard(*dpg.pad_edges_for_mesh(ei, ej, Sji, emask, D), r, D, dev)
    out["pg"] = dpg.make_distributed_pose_graph(group)(
        torch.tensor(S, device=dev), torch.tensor(vvalid, device=dev), torch.tensor(vfixed, device=dev), *edges,
        n_iters=15, fix_scale=True)

    imgs = d["fe_images"]
    ex = OrbExtractor(OrbConfig(n_features=64, n_levels=3), imgs.shape[1], imgs.shape[2], device=dev)
    kps = make_batch_extractor(group, ex)(imgs)
    for f in ("uv", "valid", "desc", "octave", "uv_level"):
        out[f"fe_{f}"] = kps[kps._fields.index(f)]
    return out


def collectives(group) -> dict:
    """psum and all_gather_rows on values each rank knows in advance."""
    r = group.rank
    return {
        "psum": group.psum(torch.tensor([r + 1.0, -0.5 * r])),
        "gather_f32": group.all_gather_rows(torch.full((2, 3), r - 1.5)),
        "gather_i32": group.all_gather_rows(torch.tensor([[-(2 ** 31) + r, r]], dtype=torch.int32)),
        "gather_bool": group.all_gather_rows(torch.tensor([[r % 2 == 0, True, False]])),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    group = init_group("gloo", args.rank, args.world, args.init_method, "cpu")
    try:
        d = dict(np.load(args.inputs))
        n0 = group.n_all_reduce
        out = solve_all(group, d)
        out["n_all_reduce"] = torch.tensor(group.n_all_reduce - n0)
        out.update(collectives(group))
        np.savez(f"{args.out}/rank{args.rank}.npz", **{k: v.cpu().numpy() for k, v in out.items()})
    finally:
        group.close()


if __name__ == "__main__":
    main()
