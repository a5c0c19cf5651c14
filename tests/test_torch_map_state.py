"""Parity of the PyTorch map model (models.map_state, ops.scatter) against
the JAX reference: after `map_state_from_numpy` puts the port in the JAX
state, every update must leave identical arrays (integers and masks bit for
bit; the float fields are copied, so also exactly)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import map_state as jms
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu_torch.models import map_state as tms
from my_orb_slam2_tpu_torch.ops.scatter import put_drop, set_last_wins
from my_orb_slam2_tpu_torch.utils import bridge

MP, KF, K_OBS, N = 96, 8, 4, 32


def _cfg(mod):
    return mod.SlamConfig(capacity=mod.CapacityConfig(max_keyframes=KF, max_map_points=MP, max_obs_per_point=K_OBS))


def _np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_states_equal(port, ref):
    a = bridge.map_state_to_numpy(port)
    for k, v in _np_state(ref).items():
        assert a[k].dtype == v.dtype, k
        assert np.array_equal(a[k], v), k


def _keyframe_inputs(rng, assign):
    uv = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    ur = np.where(rng.random(N) < 0.7, uv[:, 0] - 10, -1.0).astype(np.float32)
    depth = np.where(ur >= 0, 4.0, -1.0).astype(np.float32)
    octave = rng.integers(0, 8, N).astype(np.int32)
    angle = rng.uniform(-3, 3, N).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    valid = rng.random(N) < 0.9
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(size=3)
    return [T, np.int32(7), np.float32(0.25), uv, ur, depth, octave, angle, desc, valid, assign.astype(np.int32)]


def _jax_args(a):
    return [jnp.asarray(x) for x in a]


def _torch_args(a):
    out = []
    for x in a:
        x = np.asarray(x)
        if x.dtype == np.uint32:
            out.append(torch.tensor(x.view(np.int32)))
        elif x.dtype.kind in "iu":
            out.append(torch.tensor(x.astype(np.int64)))
        else:
            out.append(torch.tensor(x))
    return out


@pytest.fixture
def populated():
    """A JAX state with 40 points and 3 keyframes that share points (and
    assign some twice), so observer rows overlap and fill up."""
    rng = np.random.default_rng(0)
    state = jms.init_map_state(_cfg(jcfg), N)
    want = jnp.asarray(np.ones(40, bool))
    state, slots, ok = jms.add_map_points(
        state, jnp.asarray(rng.normal(size=(40, 3)), jnp.float32),
        jnp.asarray(rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)),
        jnp.zeros((40, 3)), jnp.ones(40), 2 * jnp.ones(40), jnp.zeros(40, jnp.int32), want,
    )
    for k in range(3):
        assign = rng.integers(-1, 40, N)
        assign[:3] = [0, 0, 5]  # duplicates: first slot wins
        state, _ = jms.insert_keyframe(state, *_jax_args(_keyframe_inputs(rng, assign)))
    return rng, state


def test_bridge_roundtrip(populated):
    _, state = populated
    port = bridge.map_state_from_numpy(_np_state(state), "cpu")
    assert_states_equal(port, state)
    assert int(port.n_kf) == 3


@pytest.mark.parametrize("obs_budget", [0, 3])
def test_insert_keyframe(populated, obs_budget):
    rng, state = populated
    port = bridge.map_state_from_numpy(_np_state(state), "cpu")
    assign = rng.integers(-1, 45, N)
    assign[4:8] = [1, 1, 0, 0]  # duplicate ids, including point 0
    inputs = _keyframe_inputs(rng, assign)
    ref, kf_j = jms.insert_keyframe(state, *_jax_args(inputs), obs_budget=obs_budget)
    out, kf_t = tms.insert_keyframe(port, *_torch_args(inputs), obs_budget=obs_budget)
    assert int(kf_t) == int(kf_j) == 3
    assert_states_equal(out, ref)


def test_covis_row_and_observer_votes(populated):
    rng, state = populated
    port = bridge.map_state_from_numpy(_np_state(state), "cpu")
    assign = rng.integers(-1, MP + 3, N)  # out-of-range ids too
    assign[:4] = [2, 2, 7, 7]
    ok = rng.random(N) < 0.8
    aj, at = jnp.asarray(assign.astype(np.int32)), torch.tensor(assign)
    assert np.array_equal(tms.covis_row(port, at).numpy(), np.asarray(jms.covis_row(state, aj)))
    assert np.array_equal(
        tms.observer_votes(port, at, torch.tensor(ok)).numpy(), np.asarray(jms.observer_votes(state, aj, jnp.asarray(ok)))
    )


def test_add_map_points_and_allocate(populated):
    rng, state = populated
    port = bridge.map_state_from_numpy(_np_state(state), "cpu")
    Q = 70  # more than the 56 free slots: the tail is refused
    want = rng.random(Q) < 0.9
    pos = rng.normal(size=(Q, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (Q, 8), dtype=np.uint32)
    normal = rng.normal(size=(Q, 3)).astype(np.float32)
    dmin, dmax = rng.uniform(0.5, 1, Q).astype(np.float32), rng.uniform(2, 5, Q).astype(np.float32)
    ref_kf = rng.integers(0, 3, Q).astype(np.int32)
    inputs = [pos, desc, normal, dmin, dmax, ref_kf, want]
    ref, s_j, ok_j = jms.add_map_points(state, *_jax_args(inputs))
    out, s_t, ok_t = tms.add_map_points(port, *_torch_args(inputs))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert (~np.asarray(ok_j) & want).any()
    assert_states_equal(out, ref)
    valid = rng.random(MP) < 0.5
    for v in (valid, np.ones(MP, bool), np.zeros(MP, bool)):
        sj, okj = jms.allocate_map_points(jnp.asarray(v), jnp.asarray(want))
        st, okt = tms.allocate_map_points(torch.tensor(v), torch.tensor(want))
        assert np.array_equal(st.numpy(), np.asarray(sj)) and np.array_equal(okt.numpy(), np.asarray(okj))


def test_obs_add_pairs_overflow(populated):
    rng, state = populated
    pid = np.arange(-2, N - 2)
    pid[5] = MP + 4
    kf = np.full(N, 5)
    slot = np.arange(N)
    mask = rng.random(N) < 0.9
    obs_kf = np.asarray(state.mp_obs_kf).copy()
    obs_kf[0:6] = 1  # full rows: those observations overflow
    ref = jms.obs_add_pairs(jnp.asarray(obs_kf), state.mp_obs_slot, *(jnp.asarray(a.astype(np.int32)) for a in (pid, kf, slot)), jnp.asarray(mask))
    port = tms.obs_add_pairs(torch.tensor(obs_kf.astype(np.int64)), torch.tensor(np.asarray(state.mp_obs_slot).astype(np.int64)),
                             torch.tensor(pid), torch.tensor(kf), torch.tensor(slot), torch.tensor(mask))
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy(), np.asarray(r))
    assert int(ref[3]) > 0


def test_set_last_wins_matches_jax_duplicate_scatter():
    """x.at[idx].set(vals) with repeated indices: the reference on the CPU
    keeps the last write; the port reproduces it (the map-point-0 quirk of
    track_local_map's masks)."""
    rng = np.random.default_rng(9)
    for _ in range(5):
        idx = rng.integers(0, 6, 40)
        vals = rng.random(40) < 0.5
        ref = np.asarray(jnp.zeros(8, bool).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
        port = set_last_wins(torch.zeros(8, dtype=torch.bool), torch.tensor(idx), torch.tensor(vals))
        assert np.array_equal(port.numpy(), ref)
    # masked writes of False to index 0 after a real True at index 0
    cur = np.array([0, -1, -1])
    ref = np.asarray(jnp.zeros(4, bool).at[jnp.where(cur >= 0, cur, 0)].set(cur >= 0))
    port = set_last_wins(torch.zeros(4, dtype=torch.bool), torch.tensor(np.where(cur >= 0, cur, 0)), torch.tensor(cur >= 0))
    assert np.array_equal(port.numpy(), ref) and not ref[0]


def test_put_drop_matches_mode_drop():
    rng = np.random.default_rng(10)
    base = rng.normal(size=(6, 3)).astype(np.float32)
    idx = np.array([0, 6, 3, 9, 5])
    vals = rng.normal(size=(5, 3)).astype(np.float32)
    ref = np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].set(jnp.asarray(vals), mode="drop"))
    assert np.array_equal(put_drop(torch.tensor(base), torch.tensor(idx), torch.tensor(vals)).numpy(), ref)
