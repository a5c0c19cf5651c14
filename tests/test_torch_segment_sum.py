"""Fixed-order segment sums (ops/segment_sum.py, csrc/segment_sum.cu).

- The CSR layout (a stable argsort and searchsorted) is exact: integers;
  rows outside `live` (a solve's masked padding) are left out of it.
- The plain version (`index_add_` on the CPU) against JAX's `.at[].add` on
  bundle-adjustment-shaped inputs (camera, point and (point, camera) block
  sums) and on the pose graph's two-ended edge sums, within 1e-6 relative
  (both add the rows in order on the CPU: in practice the bits agree).
- The pose graph's two-ended sum keeps its "edge_i, then edge_j" order
  bit for bit on the CPU.
- The route is chosen from shapes alone; the long route's block order
  (segments by length, longest first) against numpy's stable argsort.
- `cuda` cases: the kernel (padding left out of its layout) against the
  plain version on the CPU, which adds the padding's zeros (torch.equal:
  it sums in the CPU's order), and against itself twice, the
  launch counter, and a refused input. Both routes, on layouts that break
  a careless kernel (one segment of every row, empty first and last
  segments, segments of one row, masked padding, row counts off the stage
  size, rows of 4 to 196 B), and an order witness: values on which a
  reversed or pairwise sum gives other bits than index_add_. They skip
  without a card; jax is imported inside the tests that use it, so
  python -m pytest --noconftest tests/test_torch_segment_sum.py -m cuda
  runs on a machine without it.
"""

import numpy as np
import pytest
import torch

from my_orb_slam2_tpu_torch.ops import pose_graph
from my_orb_slam2_tpu_torch.ops import segment_sum as ss
try:
    from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
except ImportError:  # `tests` taken by another installed package: pytest puts this directory on the path
    from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def _ba_like(seed, n_cams=12, n_pts=300, n_obs=2000, n_pad=500):
    """Observation rows of a flat BA problem: camera and point index, the
    live mask, and per-row blocks of the shapes the solver sums. The last
    n_pad rows are padding, as a solve's: index 0, masked, zero blocks."""
    rng = np.random.default_rng(seed)
    cam = rng.integers(0, n_cams - 1, n_obs)  # the last camera has no observation
    pt = rng.integers(0, n_pts, n_obs)
    live = np.arange(n_obs) < n_obs - n_pad
    cam[~live], pt[~live] = 0, 0
    blocks = {"U (6, 6)": rng.normal(size=(n_obs, 6, 6)), "V (3, 3)": rng.normal(size=(n_obs, 3, 3)),
              "b_c (6,)": rng.normal(size=(n_obs, 6)), "W (6, 3)": rng.normal(size=(n_obs, 6, 3))}
    blocks = {k: np.where(live.reshape((-1,) + (1,) * (v.ndim - 1)), v, 0.0).astype(np.float32)
              for k, v in blocks.items()}
    return n_cams, n_pts, cam, pt, live, blocks


@pytest.mark.parametrize("n, dist", [(7, "uniform"), (50, "sparse"), (3, "single"), (5, "empty")])
def test_csr_is_exact(n, dist):
    rng = np.random.default_rng(n)
    idx = {"uniform": rng.integers(0, n, 400), "sparse": rng.choice([0, 9, 49], 200),
           "single": np.full(30, 1), "empty": np.zeros(0, np.int64)}[dist]
    order, offsets = ss.csr(n, torch.tensor(idx))
    counts = np.bincount(idx, minlength=n)
    assert offsets.tolist() == [0, *np.cumsum(counts).tolist()]
    assert order.tolist() == np.argsort(idx, kind="stable").tolist()


def test_csr_leaves_out_dead_rows():
    idx = np.array([2, 0, 0, 1, 0, 2, 0])
    live = np.array([1, 0, 1, 1, 0, 1, 1], bool)
    order, offsets = ss.csr(3, torch.tensor(idx), torch.tensor(live))
    assert offsets.tolist() == [0, 2, 3, 5]
    assert order[:5].tolist() == [2, 6, 3, 0, 5] and sorted(order[5:].tolist()) == [1, 4]


@pytest.mark.parametrize("which", ["cameras", "points", "blocks"])
def test_plain_matches_jax_scatter_add(which):
    jnp = pytest.importorskip("jax.numpy")
    C, P, cam, pt, _, blocks = _ba_like(1)
    n, idx = {"cameras": (C, cam), "points": (P, pt), "blocks": (P * C, pt * C + cam)}[which]
    seg = ss.segments(n, torch.tensor(idx))
    for name, v in blocks.items():
        got = ss.segment_sum(seg, torch.tensor(v)).numpy()
        want = np.asarray(jnp.zeros((n,) + v.shape[1:], jnp.float32).at[jnp.asarray(idx)].add(jnp.asarray(v)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)


def test_pose_graph_sum_matches_jax_in_order():
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(2)
    KF, E = 40, 300
    ei, ej = rng.integers(0, KF, E), rng.integers(0, KF, E)
    a, b = (rng.normal(size=(E, 7, 7)).astype(np.float32) for _ in range(2))
    seg = pose_graph.edge_segments(KF, torch.tensor(ei), torch.tensor(ej))
    got = pose_graph._seg_sum2(seg, torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(jnp.zeros((KF, 7, 7), jnp.float32).at[jnp.asarray(ei)].add(jnp.asarray(a))
                      .at[jnp.asarray(ej)].add(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    before = torch.zeros(KF, 7, 7).index_add_(0, torch.tensor(ei), torch.tensor(a)).index_add_(
        0, torch.tensor(ej), torch.tensor(b))
    assert torch.equal(torch.tensor(got), before)  # the CPU path kept its order


def test_kernel_refuses_cpu_tensors():
    seg = ss.segments(3, torch.tensor([0, 2, 2]))
    assert seg.order is None and seg.offsets is None  # the plain version needs no layout
    with pytest.raises(ValueError):
        ss._launch(seg, torch.ones(3, 6))
    n0 = ss.segment_sum.launches
    ss.segment_sum(seg, torch.ones(3, 6))
    assert ss.segment_sum.launches == n0  # the plain version launches nothing


@pytest.mark.parametrize("n, dist", [(7, "uniform"), (50, "sparse"), (3, "single"), (5, "empty"), (2048, "cameras")])
def test_longest_first_matches_numpy(n, dist):
    rng = np.random.default_rng(n)
    idx = {"uniform": rng.integers(0, n, 400), "sparse": rng.choice([0, 9, 49], 200), "single": np.full(30, 1),
           "empty": np.zeros(0, np.int64), "cameras": np.repeat(np.arange(160), rng.integers(800, 1659, 160))}[dist]
    _, offsets = ss.csr(n, torch.tensor(idx))
    counts = np.bincount(idx, minlength=n)
    assert ss.longest_first(offsets).tolist() == np.argsort(-counts, kind="stable").tolist()


def test_route_is_chosen_from_shapes():
    # a GBA tick at the loop drive's capacity: camera sums long, point sums
    # short; the pose graph's 4 rows a keyframe on average short; rows of
    # more than LONG_MAX_K components short
    assert ss.route(262_144, 2048, 36) == ss.route(262_144, 2048, 6) == "long"
    assert ss.route(262_144, 262_144, 9) == ss.route(262_144, 262_144 * 2048, 18) == "short"
    assert ss.route(8192, 2048, 49) == "short"
    assert ss.route(262_144, 2048, ss.LONG_MAX_K + 1) == "short"
    assert ss.route(ss.LONG_MIN_MEAN * 5, 5, 1) == "long" and ss.route(ss.LONG_MIN_MEAN * 5 - 1, 5, 1) == "short"
    assert ss.segments(2048, torch.zeros(262_144, dtype=torch.int64)).longest_first is None  # the CPU: no layout


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cameras", "points", "blocks"])
def test_kernel_equals_cpu_and_repeats(cuda, which):
    C, P, cam, pt, live, blocks = _ba_like(3)
    n, idx = {"cameras": (C, cam), "points": (P, pt), "blocks": (P * C, pt * C + cam)}[which]
    seg_cpu = ss.segments(n, torch.tensor(idx))
    seg = ss.segments(n, torch.tensor(idx, device=cuda), torch.tensor(live, device=cuda))
    for name, v in blocks.items():
        n0 = ss.segment_sum.launches
        x = torch.tensor(v, device=cuda)
        a, b = ss.segment_sum(seg, x), ss.segment_sum(seg, x)
        torch.cuda.synchronize()
        assert ss.segment_sum.launches == n0 + 2
        assert torch.equal(a, b), name
        assert torch.equal(a.cpu(), ss.segment_sum(seg_cpu, torch.tensor(v))), name
        torch.testing.assert_close(a, ss.plain(seg, x), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes(cuda):
    seg = ss.segments(3, torch.tensor([0, 2, 2], device=cuda))
    with pytest.raises(ValueError):
        ss.segment_sum(seg, torch.ones(3, 6, dtype=torch.float64, device=cuda))


def _layout(name, rng):
    """(n, row -> segment index, live mask) of a layout that breaks a
    careless kernel."""
    if name == "one segment of every row":  # 100,003 rows: off every stage size; segments 0 and 2 empty
        return 3, np.ones(100_003, np.int64), np.ones(100_003, bool)
    if name == "empty ends, single rows":  # segments 0 and n - 1 empty, most of the rest one row
        n = 400
        idx = np.concatenate([np.arange(1, n - 1), rng.integers(1, 20, 5000)])
        return n, rng.permutation(idx), np.ones(idx.shape[0], bool)
    if name == "cameras, masked padding":  # contiguous cameras, 3 empty, then padding at index 0
        lengths = rng.integers(0, 700, 61)
        lengths[[0, 17, 60]] = 0
        idx = np.concatenate([np.repeat(np.arange(61), lengths), np.zeros(3001, np.int64)])
        live = np.arange(idx.shape[0]) < lengths.sum()
        return 64, idx, live
    raise ValueError(name)


LAYOUTS = ["one segment of every row", "empty ends, single rows", "cameras, masked padding"]


def _card_and_cpu(cuda, n, idx, live, vals):
    """The layout on the card and the CPU's index_add_ of every row (the
    padding adds zeros)."""
    seg = ss.segments(n, torch.tensor(idx, device=cuda), torch.tensor(live, device=cuda))
    return seg, torch.zeros((n,) + vals.shape[1:]).index_add_(0, torch.tensor(idx), torch.tensor(vals))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 3, 6, 7, 9, 36, 49, 64, 100, 127, ss.LONG_MAX_K])
def test_both_routes_equal_cpu_on_hard_layouts(cuda, layout, k):
    rng = np.random.default_rng(k)
    n, idx, live = _layout(layout, rng)
    vals = np.where(live[:, None], rng.normal(size=(idx.shape[0], k)), 0.0).astype(np.float32)
    seg, want = _card_and_cpu(cuda, n, idx, live, vals)
    x = torch.tensor(vals, device=cuda)
    for name, launch in (("long", ss._launch_long), ("short", ss._launch_short), ("by shape", ss._launch)):
        a, b = launch(seg, x), launch(seg, x)
        torch.cuda.synchronize()
        assert torch.equal(a, b), name
        assert torch.equal(a.cpu(), want), name


@pytest.mark.cuda
def test_unaligned_base_takes_narrow_copies(cuda):
    # a view one float into its storage: 16 B rows whose base is 4 B aligned
    rng = np.random.default_rng(5)
    n, idx, live = _layout("cameras, masked padding", rng)
    vals = np.where(live[:, None], rng.normal(size=(idx.shape[0], 4)), 0.0).astype(np.float32)
    seg, want = _card_and_cpu(cuda, n, idx, live, vals)
    store = torch.empty(vals.size + 1, device=cuda)
    x = store[1:].view(vals.shape)
    x.copy_(torch.tensor(vals))
    assert x.data_ptr() % 16 == 4
    assert torch.equal(ss._launch_long(seg, x).cpu(), want)


def _pairwise(v):
    """A tree sum of each column of v (f32), as a reassociating kernel
    would take it."""
    v = v.astype(np.float32)
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = np.concatenate([v, np.zeros((1,) + v.shape[1:], np.float32)])
        v = (v[0::2] + v[1::2]).astype(np.float32)
    return v[0] if v.shape[0] else np.zeros(v.shape[1:], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_segment", [5, 1500])
def test_order_witness(cuda, rows_per_segment):
    # 1e8 beside 1: f32 keeps 1e8 + 1 as 1e8, so where the ones fall in the
    # chain decides the sum's bits
    rng = np.random.default_rng(rows_per_segment)
    n = 64
    idx = np.repeat(np.arange(n), rows_per_segment)
    vals = rng.choice(np.array([1e8, -1e8, 1.0, -1.0, 3.0], np.float32), size=(idx.shape[0], 6)).astype(np.float32)
    live = np.ones(idx.shape[0], bool)
    seg, want = _card_and_cpu(cuda, n, idx, live, vals)
    rev = torch.zeros(n, 6).index_add_(0, torch.tensor(idx[::-1].copy()), torch.tensor(vals[::-1].copy()))
    pair = torch.tensor(np.stack([_pairwise(vals[idx == s]) for s in range(n)]))
    assert not torch.equal(rev, want) and not torch.equal(pair, want)  # the witness sees a reordering
    x = torch.tensor(vals, device=cuda)
    for launch in (ss._launch_long, ss._launch_short, ss._launch):
        assert torch.equal(launch(seg, x).cpu(), want)


@pytest.mark.cuda
def test_long_route_refuses_wide_rows(cuda):
    seg = ss.segments(2, torch.zeros(64, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ss._launch_long(seg, torch.ones(64, ss.LONG_MAX_K + 1, device=cuda))
    out = ss.segment_sum(seg, torch.ones(64, ss.LONG_MAX_K + 1, device=cuda))  # takes the short route
    assert torch.equal(out.cpu(), torch.zeros(2, ss.LONG_MAX_K + 1).index_add_(0, torch.zeros(64, dtype=torch.int64),
                                                                             torch.ones(64, ss.LONG_MAX_K + 1)))


# ---------------------------------------------------------------------------
# The global BA's fused PCG matvec (ops/pcg_matvec.py, csrc/pcg_matvec.cu)
# ---------------------------------------------------------------------------


def _flat_ba(seed, n_cams=100, n_pts=400):
    """A flat BA problem that takes the PCG branch (6 C > 512): cameras
    along x, each point seen by 2-6 of the nearest, every fourth camera
    fixed, camera 7 seen by no row, 2% of the rows and 30 rows of padding
    (index 0) masked."""
    from my_orb_slam2_tpu_torch.ops import ba, lie

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = 500.0, 500.0, 320.0, 240.0, 40.0
    xi = np.concatenate([np.stack([-0.3 * np.arange(n_cams), np.zeros(n_cams), np.zeros(n_cams)], 1),
                         rng.normal(0, 0.01, (n_cams, 3))], 1)
    Tcw = lie.se3_exp(torch.tensor(xi, dtype=torch.float64))
    pts = np.stack([rng.uniform(-2, 0.3 * n_cams + 2, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(5, 12, n_pts)], 1)
    rows = []
    for p in range(n_pts):
        near = [c for c in np.argsort(np.abs(0.3 * np.arange(n_cams) - pts[p, 0]))[:8] if c != 7]
        for c in rng.choice(near, rng.integers(2, 7), replace=False):
            pc = Tcw[c, :3, :3].numpy() @ pts[p] + Tcw[c, :3, 3].numpy()
            u, v = fx * pc[0] / pc[2] + cx + rng.normal(0, 1), fy * pc[1] / pc[2] + cy + rng.normal(0, 1)
            ur = u - bf / pc[2] if rng.random() < 0.5 else -1.0
            rows.append((c, p, u, v, ur, 1.0 / 1.2 ** (2 * rng.integers(0, 4)), rng.random() > 0.02))
    rows += [(0, 0, 0.0, 0.0, -1.0, 1.0, False)] * 30
    r = np.array(rows)
    drift = lie.se3_exp(torch.tensor(rng.normal(0, 0.003, (n_cams, 6))))
    fixed = np.arange(n_cams) % 4 == 0
    cam = torch.where(torch.tensor(fixed)[:, None, None], Tcw, drift @ Tcw).float()
    prob = ba.BAProblem(
        cam, torch.tensor(fixed), torch.tensor(pts + rng.normal(0, 0.05, pts.shape), dtype=torch.float32),
        torch.ones(n_pts, dtype=torch.bool), torch.tensor(r[:, 0], dtype=torch.int32),
        torch.tensor(r[:, 1], dtype=torch.int32), torch.tensor(r[:, 2:4], dtype=torch.float32),
        torch.tensor(r[:, 4], dtype=torch.float32), torch.tensor(r[:, 5], dtype=torch.float32),
        torch.tensor(r[:, 6].astype(bool)))
    return prob, (fx, fy, cx, cy, bf)


def _old_matvec(prob):
    """The PCG step's S x as bundle_adjust composed it before the fused
    kernels, from the Schur operands and the problem's own indices."""
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    cam_seg = ss.segments(prob.cam_Tcw.shape[0], prob.obs_cam, prob.obs_mask)
    pt_seg = ss.segments(prob.pt_pos.shape[0], prob.obs_pt, prob.obs_mask)

    def S_matvec(S: pm.Schur, x):
        x = x * S.free_cam
        y = ss.segment_sum(pt_seg, torch.einsum("oij,oi->oj", S.Wo, x[prob.obs_cam]))
        y = torch.einsum("pij,pj->pi", S.V_inv, y)
        t2 = ss.segment_sum(cam_seg, torch.einsum("oij,oj->oi", S.Wo, y[prob.obs_pt]))
        return (torch.einsum("cij,cj->ci", S.U_d, x) - t2) * S.free_cam

    return S_matvec


def test_pcg_matvec_plain_is_the_old_composition(monkeypatch):
    # every PCG step of a CPU solve: the plain version against the old
    # S_matvec on the same operands, bit for bit
    from my_orb_slam2_tpu_torch.ops import ba
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    prob, cam = _flat_ba(0)
    assert prob.cam_Tcw.shape[0] * 6 > 512 and not bool(prob.obs_mask.all())
    old, plain, steps = _old_matvec(prob), pm.schur_matvec, []

    def checked(S, x):
        got = plain(S, x)
        steps.append(torch.equal(got, old(S, x)) and bool(got.abs().sum() > 0))
        return got

    monkeypatch.setattr(pm, "schur_matvec", checked)
    ba.bundle_adjust(prob, *cam, n_iters=2, cg_iters=8)
    assert len(steps) == 16 and all(steps)


def test_bundle_adjust_pcg_unchanged_on_cpu(monkeypatch):
    # the whole solve with the fused path's plain version against the same
    # solve through the old S_matvec: the same bits
    from my_orb_slam2_tpu_torch.ops import ba
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    prob, cam = _flat_ba(1)
    got, lam = ba.bundle_adjust(prob, *cam, n_iters=3, cg_iters=16, return_lam=True)
    monkeypatch.setattr(pm, "schur_matvec", _old_matvec(prob))
    want, lam_old = ba.bundle_adjust(prob, *cam, n_iters=3, cg_iters=16, return_lam=True)
    assert float((got.cam_Tcw - prob.cam_Tcw).abs().max()) > 1e-4  # it moved
    assert torch.equal(got.cam_Tcw, want.cam_Tcw) and torch.equal(got.pt_pos, want.pt_pos)
    assert torch.equal(lam, lam_old)


def _matvec_case(name, seed):
    """(C, P, camera / point index, live mask, Wo, V_inv, U_d, free_cam, x)
    as numpy f32 on a layout that breaks a careless kernel."""
    rng = np.random.default_rng(seed)
    if name == "one 1658-row camera":  # phase 9's longest camera among 2048 slots, most of them empty
        C, P, O, n_pad = 2048, 20_000, 40_000, 3000
        cam = rng.integers(1, 101, O)
        cam[rng.permutation(O - n_pad)[:1658]] = 0
        pt = rng.integers(0, 9000, O)
    elif name == "one-row points":  # every point one row, cameras short of the long route's mean
        C, P, O, n_pad = 300, 5000, 4600, 100
        cam = rng.integers(0, 290, O)
        pt = rng.permutation(P)[:O]
    elif name == "empty and fixed cameras":  # every other camera fixed, a third of them with no row
        C, P, O, n_pad = 96, 3000, 12_000, 500
        cam = rng.choice(np.arange(0, C, 3)[1:], O)
        pt = rng.integers(0, P - 100, O)
    else:
        raise ValueError(name)
    live = np.arange(O) < O - n_pad
    cam[~live], pt[~live] = 0, 0
    free = np.ones(C, np.float32) if name != "empty and fixed cameras" else (np.arange(C) % 2).astype(np.float32)
    free[0] = 0.0  # the anchor
    Wo = (rng.normal(size=(O, 6, 3)) * live[:, None, None]).astype(np.float32)
    V = rng.normal(size=(P, 3, 3)).astype(np.float32)
    U = rng.normal(size=(C, 6, 6)).astype(np.float32)
    return C, P, cam, pt, live, Wo, V, U, free[:, None], rng.normal(size=(C, 6)).astype(np.float32)


MATVEC_CASES = ["one 1658-row camera", "one-row points", "empty and fixed cameras"]


def _cpu_plan(C, P, cam, pt, live):
    """A plan with the CUDA path's tables, built on the CPU."""
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    def seg(n, idx):
        order, off = ss.csr(n, torch.tensor(idx), torch.tensor(live))
        return ss.Segments(n, torch.tensor(idx), order, off, ss.longest_first(off))

    return pm.plan(seg(C, cam), seg(P, pt))


def test_pcg_matvec_route_is_chosen_from_shapes():
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    assert pm.route(262_144, 262_144) == "short"  # the benchmark's points: 1 row a slot
    assert pm.route(262_144, 1536) == "long" and pm.route(262_144, 2048) == "long"  # its cameras, phase 9's
    assert pm.route(15 * 300, 300) == "short" and pm.route(16 * 300, 300) == "long"
    for name in MATVEC_CASES:
        C, P, cam, pt, live, *_ = _matvec_case(name, 0)
        p = _cpu_plan(C, P, cam, pt, live)
        for t, n in ((p.points, P), (p.cameras, C)):
            assert t.long == (pm.route(cam.shape[0], n) == "long")
            assert (t.longest_first is None) == (not t.long)
            assert t.nbr.dtype == t.offsets.dtype == torch.int32
    assert not pm.plan(ss.segments(4, torch.zeros(3)), ss.segments(4, torch.zeros(3))).points  # CPU: no tables


@pytest.mark.parametrize("bad", ["cpu x", "float64 x", "x shape", "Wo shape", "V_inv dtype", "U_d device"])
def test_pcg_matvec_kernel_refuses(bad):
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    C, P, cam, pt, live, Wo, V, U, free, x = (torch.tensor(a) if isinstance(a, np.ndarray) else a
                                             for a in _matvec_case("empty and fixed cameras", 1))
    p = _cpu_plan(C, P, cam.numpy(), pt.numpy(), live.numpy())
    ops = {"Wo": Wo, "V_inv": V, "U_d": U, "free_cam": free}
    if bad == "Wo shape":
        ops["Wo"] = Wo[:-1]
    if bad == "V_inv dtype":
        ops["V_inv"] = V.double()
    if bad == "U_d device":
        ops["U_d"] = U.to("meta")
    if bad == "x shape":
        x = x[:, :5]
    if bad == "float64 x":
        x = x.double()
    n0 = pm.schur_matvec.launches
    with pytest.raises(ValueError):
        pm._launch(pm.schur(p, **ops), x)
    assert pm.schur_matvec.launches == n0
    if bad == "cpu x":  # with the CPU's layouts the same operands take the plain version
        cpu = pm.plan(ss.segments(C, cam), ss.segments(P, pt))
        assert torch.equal(pm.schur_matvec(pm.schur(cpu, **ops), x), pm.plain(pm.schur(cpu, **ops), x))
        assert pm.schur_matvec.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATVEC_CASES)
@pytest.mark.parametrize("routes", ["by shape", "short, short", "short, long", "long, short", "long, long"])
def test_pcg_matvec_kernels_match_plain_and_repeat(cuda, case, routes):
    # Tolerance: each row's 3- or 6-term product is a chain of fused
    # multiply-adds on the card and the CPU einsum's own rounding here, a
    # few ulps apart; the sums take the same rows in the same order. So the
    # kernels stay within 64 u (u = 2^-24) of the terms' magnitude, S x
    # taken with every operand's absolute value and the subtraction an add.
    from my_orb_slam2_tpu_torch.ops import pcg_matvec as pm

    C, P, cam, pt, live, Wo, V, U, free, x = _matvec_case(case, 2)
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    p = pm.plan(ss.segments(C, t(cam), t(live)), ss.segments(P, t(pt), t(live)))
    if routes != "by shape":  # each pass forced to a route
        for side, seg, r in zip(("points", "cameras"), (p.pt_seg, p.cam_seg), routes.split(", ")):
            lg = r == "long"
            p = p._replace(**{side: getattr(p, side)._replace(long=lg, longest_first=seg.longest_first.int() if lg
                                                              else None)})
    S = pm.schur(p, t(Wo), t(V), t(U), t(free))
    n0 = pm.schur_matvec.launches
    a, b = pm.schur_matvec(S, t(x)), pm.schur_matvec(S, t(x))
    torch.cuda.synchronize()
    assert pm.schur_matvec.launches == n0 + 4
    assert torch.equal(a, b)
    cpu = pm.plan(ss.segments(C, torch.tensor(cam)), ss.segments(P, torch.tensor(pt)))
    want = pm.plain(pm.schur(cpu, *map(torch.tensor, (Wo, V, U, free))), torch.tensor(x))
    W_a, V_a, U_a = (torch.tensor(np.abs(v)) for v in (Wo, V, U))
    free_t, cam_t, pt_t = torch.tensor(free), torch.tensor(cam), torch.tensor(pt)
    x_a = torch.tensor(np.abs(x)) * free_t
    y_a = torch.einsum("pij,pj->pi", V_a, torch.zeros(P, 3).index_add_(0, pt_t, torch.einsum("oij,oi->oj", W_a,
                                                                                              x_a[cam_t])))
    t_a = torch.zeros(C, 6).index_add_(0, cam_t, torch.einsum("oij,oj->oi", W_a, y_a[pt_t]))
    scale = (torch.einsum("cij,cj->ci", U_a, x_a) + t_a) * free_t
    assert bool(((a.cpu() - want).abs() <= 64 * 2.0 ** -24 * scale).all())
    assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
