"""Relocalization: recover the pose of a lost frame from the keyframe
database (counterpart of my_orb_slam2_tpu/models/relocalization.py).

Per candidate keyframe: descriptor matching (>= 15) -> EPnP RANSAC over the
matched map points -> pose optimization -> projection rescue against the
candidate's own observation row (th 10, ORB distance 100) -> pose
optimization, and a second narrow rescue (th 3, distance 64) when just
under the bar; accepted at >= 50 inliers. The accepted candidate with the
most inliers wins, the first on ties.

The reference evaluates the 16 candidate slots with `lax.map`; the port
loops over the valid ones on the device stream. Invalid slots score -1 in
the reference, so skipping them cannot change the winner. The RANSAC
uniforms for all 16 slots come from one draw, (16, 128, N), of the
injectable source `draws` (ops/draws.py; seed 7, where the reference's key
chain starts at PRNGKey(7)); slot c takes row c whether or not the slots
before it are valid. Host reads per relocalization: the candidate ids (one
copy, where the reference reads `any(ids >= 0)`) and the packed result of
the winner (one copy).
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.models import keyframe_db as kdb
from my_orb_slam2_tpu_torch.models import map_state as ms
from my_orb_slam2_tpu_torch.models.frame import FrameData
from my_orb_slam2_tpu_torch.ops import matching, pose_opt
from my_orb_slam2_tpu_torch.ops.draws import DeviceUniforms
from my_orb_slam2_tpu_torch.ops.epnp import ransac_epnp
from my_orb_slam2_tpu_torch.ops.projection import project_stereo
from my_orb_slam2_tpu_torch.ops.scatter import set_last_wins
from my_orb_slam2_tpu_torch.utils.config import SlamConfig

RANSAC_ITERS = 128
MAX_CANDIDATES = 16


def _rescue_search(cfg: SlamConfig, state, frame, Tcw, cand_pts, cand_search, cur_mp_in, radius: float,
                   orb_dist: float, extra_gate):
    """Project the candidate keyframe's (compacted) points with the current
    pose and claim still-free keypoints. Returns (cur_mp, n_added)."""
    cam = cfg.camera
    uvr, z = project_stereo(Tcw, state.mp_pos[cand_pts], cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    in_img = (uvr[:, 0] >= 0) & (uvr[:, 0] < cam.width) & (uvr[:, 1] >= 0) & (uvr[:, 1] < cam.height) & (z > 0)
    Nc = cand_pts.shape[0]
    zeros = torch.zeros(Nc, dtype=torch.int64, device=cand_pts.device)
    idx, ok, _ = matching.search_by_projection(
        uvr[:, :2], zeros, cand_search & in_img & extra_gate, state.mp_desc[cand_pts],
        torch.full((Nc,), radius, device=cand_pts.device), frame.uv, frame.octave, frame.valid, frame.desc,
        level_lo=zeros, level_hi=torch.full_like(zeros, cfg.orb.n_levels - 1),
        max_dist=orb_dist, ratio=1.0, kp_taken=cur_mp_in >= 0,
    )
    N = frame.uv.shape[0]
    add_mp = torch.full((N,), ms.INVALID, dtype=torch.int64, device=idx.device).scatter_reduce(
        0, torch.where(ok, idx, N - 1), torch.where(ok, cand_pts, ms.INVALID), "amax"
    )
    return torch.where(cur_mp_in >= 0, cur_mp_in, add_mp), ok.sum()


def _matched_mask(MP: int, cur_mp):
    """zeros(MP).at[where(cur >= 0, cur, 0)].set(cur >= 0), last wins."""
    has = cur_mp >= 0
    return set_last_wins(torch.zeros(MP, dtype=torch.bool, device=cur_mp.device), torch.where(has, cur_mp, 0), has)


def _try_candidate(cfg: SlamConfig, state: ms.MapState, frame: FrameData, kf_id: int, uniforms):
    """Attempt relocalization against one candidate keyframe with its
    (n_iters, N) RANSAC uniforms. Returns (ok, Tcw, cur_mp, n_inliers)."""
    cam = cfg.camera
    MP = state.mp_pos.shape[0]
    dev = frame.uv.device
    kf_mp = state.kf_mp[kf_id]
    has_mp = kf_mp >= 0
    # 1. descriptor matching frame -> candidate keypoints with map points
    idx, ok, _ = matching.search_brute(
        frame.desc, frame.valid, state.kf_desc[kf_id], state.kf_kp_valid[kf_id] & has_mp,
        frame.angle, state.kf_angle[kf_id], max_dist=float(cfg.matcher.th_low), ratio=0.75,
    )
    cur_mp = torch.where(ok, kf_mp[idx], ms.INVALID)
    lm = torch.clamp(cur_mp, min=0)
    match_ok = (cur_mp >= 0) & state.mp_valid[lm]
    n_matches = match_ok.sum()

    # 2. EPnP RANSAC (minimal set 4, chi2 5.991 * sigma2)
    sigma2, inv_sigma2 = ms.scale_sigma2_table(cfg.orb.scale_factor, cfg.orb.n_levels, dev)
    pnp = ransac_epnp(uniforms, state.mp_pos[lm], frame.uv, match_ok, 5.991 * sigma2[frame.octave],
                      cam.fx, cam.fy, cam.cx, cam.cy)
    Tcw0 = torch.eye(4, dtype=torch.float32, device=dev)
    Tcw0[:3, :3] = pnp["R"]
    Tcw0[:3, 3] = pnp["t"]
    cur_mp1 = torch.where(pnp["inliers"], cur_mp, ms.INVALID)

    # 3. pose optimization
    inv_s2 = 1.0 / sigma2[frame.octave]

    def optimize(Tcw, cur, gate=None):
        lmx = torch.clamp(cur, min=0)
        m = (cur >= 0) & state.mp_valid[lmx]
        if gate is not None:
            m = m & gate
        return pose_opt.pose_optimization(Tcw, state.mp_pos[lmx], frame.uv, frame.ur, inv_s2, m,
                                          cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    po = optimize(Tcw0, cur_mp1)
    cur_mp2 = torch.where(po["inliers"], cur_mp1, ms.INVALID)

    # Compacted rescue candidates: the keyframe's own observation row.
    cand_pts = torch.where(has_mp, kf_mp, 0)
    cand_valid = has_mp & state.mp_valid[cand_pts] & state.kf_kp_valid[kf_id]

    # 4. projection rescue (th 10, ORB distance 100)
    search1 = cand_valid & ~_matched_mask(MP, cur_mp2)[cand_pts]
    cur_mp3, _ = _rescue_search(cfg, state, frame, po["Tcw"], cand_pts, search1, cur_mp2, radius=10.0,
                                orb_dist=100.0, extra_gate=torch.ones_like(search1))

    # 5. final pose optimization
    po2 = optimize(po["Tcw"], cur_mp3)
    cur_mp_final = torch.where(po2["inliers"], cur_mp3, ms.INVALID)
    n_final = po2["n_inliers"]

    # 6. second narrow rescue when 30 <= inliers < 50 (th 3, distance 64);
    # the re-optimization counts only when the combined set reaches 50.
    need2 = (n_final >= 30) & (n_final < 50)
    search2 = cand_valid & ~_matched_mask(MP, cur_mp_final)[cand_pts]
    cur_mp4, n_add3 = _rescue_search(cfg, state, frame, po2["Tcw"], cand_pts, search2, cur_mp_final,
                                     radius=3.0, orb_dist=64.0, extra_gate=need2.expand(search2.shape))
    run2 = need2 & (n_final + n_add3 >= 50)
    po3 = optimize(po2["Tcw"], cur_mp4, gate=run2)
    Tcw_out = torch.where(run2, po3["Tcw"], po2["Tcw"])
    cur_out = torch.where(run2, torch.where(po3["inliers"], cur_mp4, ms.INVALID), cur_mp_final)
    n_out = torch.where(run2, po3["n_inliers"], n_final)
    accept = (n_matches >= 15) & (pnp["n_inliers"] >= 4) & (n_out >= 50)
    return accept, Tcw_out, cur_out, n_out


class Relocalizer:
    """Host side: query the database, evaluate the candidates on the
    device, read the winner back once."""

    def __init__(self, cfg: SlamConfig, vocab, device, draws=None):
        self.cfg = cfg
        self.vocab = vocab
        self.draws = draws if draws is not None else DeviceUniforms(7, device)

    def relocalize(self, state: ms.MapState, db: kdb.KfDatabase, frame: FrameData):
        """Returns (ok, Tcw (4, 4) numpy or None, cur_mp (N,) or None,
        n_inliers, kf_id)."""
        ids, _ = kdb.detect_reloc_candidates(db, state, self.vocab.words(frame.desc), frame.valid,
                                             max_candidates=MAX_CANDIDATES)
        ids_host = ids.cpu().tolist()
        if not any(i >= 0 for i in ids_host):
            return False, None, None, 0, -1
        u = self.draws((len(ids_host), RANSAC_ITERS, frame.uv.shape[0]))
        results = [(c, _try_candidate(self.cfg, state, frame, kid, u[c])) for c, kid in enumerate(ids_host) if kid >= 0]
        accs = torch.stack([r[1][0] for r in results])
        ns = torch.stack([r[1][3] for r in results])
        best = torch.argmax(torch.where(accs, ns, -1))
        Tcws = torch.stack([r[1][1] for r in results])
        curs = torch.stack([r[1][2] for r in results])
        kfs = torch.tensor([ids_host[r[0]] for r in results], dtype=torch.float32, device=ns.device)
        packed = torch.cat([accs[best].reshape(1).float(), ns[best].reshape(1).float(), kfs[best].reshape(1),
                            Tcws[best].reshape(16)]).cpu().numpy()
        if not packed[0]:
            return False, None, None, 0, -1
        return True, packed[3:].reshape(4, 4).copy(), curs[best], int(packed[1]), int(packed[2])
