"""Global bundle adjustment solves: ORB-SLAM2's full-map BA after a loop
closure (LoopClosing.cc: 10 iterations), driven exactly as the system's
asynchronous GBA drives it (`AsyncGba.step`): one `bundle_adjust` call an
LM iteration with `cg_iters` PCG steps, the damping carried from call to
call, `iterations` calls a solve, a device synchronize at its end. Every
solve starts from the same problem (`gba_problem.build`, from the seed).

Set-up builds the problem on the card and runs one solve (every kernel
built and loaded). A traced run profiles one more solve. The window runs
solves until `seconds` have passed; `gba_ms` is the window's host-clock
length over the solves it completed.

The check: the window's first solve, one drawn from the seed and its last
are followed by the reference iteration by iteration from their own
states, over the traffic file's `check.follow_iterations` first
iterations (`checks.gba_step_gap`).
"""

from __future__ import annotations

import time

import numpy as np

from slam_bench import checks, gba_problem
from slam_bench.drivers import Run, peak_bytes, setup_seconds, sync


def run(r: Run) -> dict:
    import torch

    from my_orb_slam2_tpu_torch.ops import ba

    from slam_bench import trace

    c, tr = r.cell.config, r.cell.traffic
    cam = c["camera"]
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["bf"])
    iters, cg = int(tr["iterations"]), int(tr["cg_iters"])
    problem = gba_problem.build(c, tr, r.seed, r.device)
    start = ba.BAProblem(**{f: problem[f] for f in gba_problem.FIELDS})
    bundle_adjust = ba.bundle_adjust
    if r.control == "tf32":
        # The control: the reference in the system's place, its products in
        # TF32 (the system's own TF32 switch reaches few of its products:
        # cuBLAS runs its small batched products on the FP32 cores).
        from slam_bench.reference import global_ba as ref_gba

        start = ref_gba.BAProblem(**{f: problem[f] for f in gba_problem.FIELDS})

        def bundle_adjust(*a, **k):
            with ref_gba.tf32_products():
                return ref_gba.bundle_adjust(*a, **k)

    live = problem["obs_mask"]
    rows_live = int(live.sum())
    # The segments that hold a live row, by the segment count of a sum.
    live_segments = {cap_n: int(torch.unique(problem[f][live]).numel())
                     for cap_n, f in ((problem["cam_Tcw"].shape[0], "obs_cam"), (problem["pt_pos"].shape[0], "obs_pt"))}
    sums = []  # (live segments, k) of each segment sum in a traced solve
    ranges = {"on": False}

    def solve(keep=False):
        """One solve; with `keep`, the state after every iteration:
        [(cam_Tcw, pt_pos, lam)] from the start."""
        p = start
        lam = torch.tensor(1e-4, dtype=torch.float32, device=start.pt_pos.device)
        chain = [(p.cam_Tcw, p.pt_pos, lam)] if keep else None
        for _ in range(iters):
            if ranges["on"]:
                from torch.profiler import record_function

                with record_function("gba_iter"):
                    p, lam = bundle_adjust(p, *args, n_iters=1, cg_iters=cg, lam0=lam, return_lam=True)
            else:
                p, lam = bundle_adjust(p, *args, n_iters=1, cg_iters=cg, lam0=lam, return_lam=True)
            if keep:
                chain.append((p.cam_Tcw, p.pt_pos, lam))
        sync(r.device)
        return chain

    solve()  # warm-up
    traced = None
    if r.trace:
        seg_sum = ba.segment_sum

        def counted(seg, vals):
            sums.append((live_segments[seg.n], int(np.prod(vals.shape[1:]))))
            return seg_sum(seg, vals)

        ba.segment_sum = counted
        ranges["on"] = True
        try:
            traced = trace.profiled(solve, ranges=("gba_iter",), kernels=("segment_sum",))
        finally:
            ba.segment_sum = seg_sum
            ranges["on"] = False

    # The solves the check follows: the window's first, one drawn from the
    # seed among the next eight, and its last.
    pick = 1 + int(np.random.default_rng(r.seed).integers(0, 8))
    chains, last, n_solves = {}, None, 0
    t0 = time.perf_counter()
    setup_s = setup_seconds()
    while True:
        last = solve(keep=True)
        if n_solves in (0, pick):
            chains[n_solves] = last
        n_solves += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    elapsed = time.perf_counter() - t0
    peak = peak_bytes(r.device)
    chains[n_solves - 1] = last
    failed = sum(1 for ch in chains.values()
                 if not (torch.isfinite(ch[-1][0]).all() and torch.isfinite(ch[-1][1]).all()))
    numbers = checks.gba_step_gap(problem, list(chains.values()), cam, cg, int(tr["check"]["follow_iterations"]))
    ties, per_iteration = numbers.pop("ties"), numbers.pop("per_iteration")
    readings = {"trace": traced, "iterations": iters, "sums": sums, "rows_live": rows_live}
    return {
        "metrics": {"gba_ms": elapsed * 1e3 / n_solves, "setup_s": setup_s},
        "readings": readings, "checks": numbers, "attempted": n_solves, "failed": failed,
        "memory_peak_bytes": peak, "trace": traced,
        "info": {**gba_problem.counts(problem), "solves_checked": sorted(chains), "decision_ties": ties, "per_iteration": per_iteration,
                 "lams": [float(x[2]) for x in chains[min(chains)]]},
    }
