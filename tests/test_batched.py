"""Batched-innovation update vs the sequential reference chain."""
import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched, ekf
from ekf_slam_tpu.ops.observations import obs_from_rows

from test_ekf_core import make_pair, dense_of

PARAMS = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                   dtype=jnp.float64)


def measurement_of(state, slot, noise=0.0, rng=None):
    x = np.asarray(state.x)
    lm = x[3 + 2 * slot:5 + 2 * slot]
    d = lm - x[:2]
    r = np.hypot(*d)
    b = np.mod(np.rad2deg(np.arctan2(d[1], d[0])) - x[2], 360.0)
    if rng is not None:
        r += rng.normal(0, noise)
        b += rng.normal(0, noise * 50)
    return np.array([r, b, float(slot + 1)])


def test_batch_of_one_matches_sequential():
    state, _ = make_pair(3, seed=2)
    z = measurement_of(state, 1)
    z[0] += 0.05  # small innovation
    R = np.diag([z[0] * 0.1, z[1] * 5.0])
    seq = ekf.update(state, jnp.asarray(z), 1, jnp.asarray(R), PARAMS)
    bat = batched.update_batch(
        state, jnp.asarray(z)[None, :], jnp.asarray([1]),
        jnp.asarray(R)[None], jnp.ones((1,), bool), PARAMS)
    np.testing.assert_allclose(np.asarray(bat.x), np.asarray(seq.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(bat.P), np.asarray(seq.P),
                               rtol=1e-8, atol=1e-11)


def test_masked_rows_are_noops():
    state, _ = make_pair(3, seed=2)
    z1 = measurement_of(state, 0)
    z1[0] += 0.03
    R1 = np.diag([z1[0] * 0.1, z1[1] * 5.0])
    zpad = np.array([7.7, 123.0, 2.0])     # garbage in a masked slot
    Rpad = np.diag([1.0, 1.0])
    only = batched.update_batch(
        state, jnp.asarray(z1)[None], jnp.asarray([0]),
        jnp.asarray(R1)[None], jnp.ones((1,), bool), PARAMS)
    padded = batched.update_batch(
        state, jnp.asarray(np.stack([z1, zpad])), jnp.asarray([0, 1]),
        jnp.asarray(np.stack([R1, Rpad])), jnp.asarray([True, False]),
        PARAMS)
    np.testing.assert_allclose(np.asarray(padded.x), np.asarray(only.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(padded.P), np.asarray(only.P),
                               rtol=1e-8, atol=1e-11)


def test_batch_close_to_sequential_small_innovations(rng):
    """For small innovations the joint update ≈ the sequential chain
    (they differ only through relinearization order)."""
    state, _ = make_pair(4, seed=5)
    zs, Rs = [], []
    for slot in range(3):
        z = measurement_of(state, slot, noise=0.01, rng=rng)
        zs.append(z)
        Rs.append(np.diag([z[0] * 0.1, z[1] * 5.0]))
    seq = state
    for slot in range(3):
        seq = ekf.update(seq, jnp.asarray(zs[slot]), slot,
                         jnp.asarray(Rs[slot]), PARAMS)
    bat = batched.update_batch(
        state, jnp.asarray(np.stack(zs)), jnp.asarray([0, 1, 2]),
        jnp.asarray(np.stack(Rs)), jnp.ones((3,), bool), PARAMS)
    d_seq = dense_of(seq)
    d_bat = dense_of(bat)
    np.testing.assert_allclose(d_bat[0], d_seq[0], atol=2e-3)
    np.testing.assert_allclose(d_bat[1], d_seq[1], atol=2e-3)


def test_duplicate_slots_stay_sane():
    """Two measurements of the SAME landmark in one batch: the joint solve
    handles the correlation; covariance must stay PSD-ish and shrink."""
    state, _ = make_pair(2, seed=8)
    z1 = measurement_of(state, 0)
    z2 = z1.copy()
    z1[0] += 0.02
    z2[0] -= 0.01
    Rs = np.stack([np.diag([z1[0] * 0.1, z1[1] * 5.0]),
                   np.diag([z2[0] * 0.1, z2[1] * 5.0])])
    bat = batched.update_batch(
        state, jnp.asarray(np.stack([z1, z2])), jnp.asarray([0, 0]),
        jnp.asarray(Rs), jnp.ones((2,), bool), PARAMS)
    d = 3 + 2 * 2
    P = np.asarray(bat.P)[:d, :d]
    assert np.all(np.isfinite(P))
    evals = np.linalg.eigvalsh(0.5 * (P + P.T))
    assert evals.min() > -1e-9
    P0 = np.asarray(state.P)[:d, :d]
    assert np.trace(P) < np.trace(P0)


def test_measure_batched_appends_and_updates():
    state, _ = make_pair(0)
    u = jnp.array([0.05, 2.0])
    obs = obs_from_rows(
        [[2.0, 10.0, 1]], [[2.0, 0.35]], PARAMS.max_obs, jnp.float64)
    s1 = batched.measure_batched(state, obs, u, PARAMS)
    assert int(s1.n_active) == 1
    # next tick: same landmark observed again + a new one
    obs2 = obs_from_rows(
        [[2.0, 10.0, 1], [1.5, 100.0, 2]],
        [[2.0, 0.35], [-0.3, 1.5]], PARAMS.max_obs, jnp.float64)
    s2 = batched.measure_batched(s1, obs2, u, PARAMS)
    assert int(s2.n_active) == 2
    assert np.all(np.isfinite(np.asarray(s2.P)))


def test_measure_batched_jits_fixed_shape():
    state, _ = make_pair(2, seed=3)
    u = jnp.array([0.05, 2.0])
    f = jax.jit(lambda s, o: batched.measure_batched(s, o, u, PARAMS))
    z = measurement_of(state, 0)
    obs = obs_from_rows([z.tolist()], [[0.0, 0.0]], PARAMS.max_obs,
                        jnp.float64)
    out = f(state, obs)
    assert int(out.n_active) == 2


def test_update_batch_rows_mode_matches_dense():
    """pht_mode='rows' (P·Hᵀ from the observed rows of a symmetric P)
    must match the dense-Hᵀ GEMM path to fp round-off, including masked
    lanes, and preserve symmetry."""
    state, _ = make_pair(5, seed=17)
    state = state._replace(P=0.5 * (state.P + state.P.T))
    rng = np.random.default_rng(2)
    zs, Rs = [], []
    for slot in [0, 4, 2, 1]:
        z = measurement_of(state, slot, noise=0.02, rng=rng)
        zs.append(z)
        Rs.append(np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0]))
    zs_j = jnp.asarray(np.stack(zs))
    Rs_j = jnp.asarray(np.stack(Rs))
    slots = jnp.asarray([0, 4, 2, 1])
    valid = jnp.asarray([True, True, False, True])   # one masked lane

    rows_p = dataclasses_replace(PARAMS, pht_mode="rows")
    a = batched.update_batch(state, zs_j, slots, Rs_j, valid, PARAMS)
    b = batched.update_batch(state, zs_j, slots, Rs_j, valid, rows_p)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(np.asarray(b.P), np.asarray(a.P),
                               rtol=1e-9, atol=1e-12)
    Pb = np.asarray(b.P)
    assert np.max(np.abs(Pb - Pb.T)) < 1e-12


def test_rows_mode_stays_symmetric_over_chain():
    """The rows-mode posterior P − Z·S⁻¹·Zᵀ is symmetric in algebra; a
    chain of updates must keep fp asymmetry at round-off level (the
    invariant the mode relies on)."""
    state, _ = make_pair(6, seed=23)
    state = state._replace(P=0.5 * (state.P + state.P.T))
    rows_p = dataclasses_replace(PARAMS, pht_mode="rows")
    rng = np.random.default_rng(9)
    for it in range(5):
        zs, Rs, sl = [], [], []
        for slot in rng.integers(0, 6, 3):
            z = measurement_of(state, int(slot), noise=0.05, rng=rng)
            zs.append(z)
            Rs.append(np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0]))
            sl.append(int(slot))
        state = batched.update_batch(
            state, jnp.asarray(np.stack(zs)), jnp.asarray(sl),
            jnp.asarray(np.stack(Rs)), jnp.ones(3, bool), rows_p)
    P = np.asarray(state.P)
    assert np.all(np.isfinite(P))
    assert np.max(np.abs(P - P.T)) < 1e-11


def test_update_chunked_matches_manual_chunks():
    """update_chunks=G equals applying update_batch to each chunk in
    sequence (the gate/linearization semantics are pinned by construction;
    this pins the plumbing and the M%G fallback)."""
    state, _ = make_pair(4, seed=7)
    rng = np.random.default_rng(3)
    zs, Rs = [], []
    for slot in [0, 1, 2, 3]:
        z = measurement_of(state, slot, noise=0.01, rng=rng)
        zs.append(z)
        Rs.append(np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0]))
    zs_j = jnp.asarray(np.stack(zs))
    Rs_j = jnp.asarray(np.stack(Rs))
    slots = jnp.asarray([0, 1, 2, 3])
    valid = jnp.ones((4,), bool)
    p2 = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                   dtype=jnp.float64, update_chunks=2)
    got = batched.update_chunked(state, zs_j, slots, Rs_j, valid, p2)
    want = batched.update_batch(state, zs_j[:2], slots[:2], Rs_j[:2],
                                valid[:2], PARAMS)
    want = batched.update_batch(want, zs_j[2:], slots[2:], Rs_j[2:],
                                valid[2:], PARAMS)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(np.asarray(got.P), np.asarray(want.P),
                               rtol=1e-12, atol=0)
    # non-divisible G: ceil-divide into chunks of ceil(M/G) with a smaller
    # remainder chunk — G=3 over M=4 gives chunks [0:2],[2:4], same as G=2
    # (previously this silently fell back to the single joint update)
    p3 = dataclasses_replace(p2, update_chunks=3)
    fb = batched.update_chunked(state, zs_j, slots, Rs_j, valid, p3)
    np.testing.assert_allclose(np.asarray(fb.P), np.asarray(want.P),
                               rtol=1e-12, atol=0)
    # G=5 over M=7: chunks of 2,2,2,1 — remainder chunk exercised
    z7 = jnp.concatenate([zs_j, zs_j[:3]])
    R7 = jnp.concatenate([Rs_j, Rs_j[:3]])
    s7 = jnp.concatenate([slots, slots[:3]])
    v7 = jnp.ones((7,), bool)
    p5 = dataclasses_replace(p2, update_chunks=5)
    got7 = batched.update_chunked(state, z7, s7, R7, v7, p5)
    want7 = state
    for a, b in [(0, 2), (2, 4), (4, 6), (6, 7)]:
        want7 = batched.update_batch(want7, z7[a:b], s7[a:b], R7[a:b],
                                     v7[a:b], PARAMS)
    np.testing.assert_allclose(np.asarray(got7.P), np.asarray(want7.P),
                               rtol=1e-12, atol=0)


def dataclasses_replace(p, **kw):
    import dataclasses
    return dataclasses.replace(p, **kw)


def test_gate_batch_matches_scalar_gate():
    from ekf_slam_tpu.ops.association import gate, gate_batch
    state, _ = make_pair(4, seed=9)
    rng = np.random.default_rng(2)
    zs, Rs = [], []
    for slot in [0, 2, 3, 1]:
        z = measurement_of(state, slot, noise=0.05, rng=rng)
        zs.append(z)
        Rs.append(np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0]))
    # plus one brand-new signature
    zs.append(np.array([1.0, 45.0, 9.0]))
    Rs.append(np.diag([0.1, 225.0]))
    zs_j = jnp.asarray(np.stack(zs))
    Rs_j = jnp.asarray(np.stack(Rs))
    new_b, slot_b = gate_batch(state, zs_j, Rs_j, PARAMS)
    for m in range(len(zs)):
        new_s, slot_s, _ = gate(state, zs_j[m], Rs_j[m], PARAMS)
        assert bool(new_b[m]) == bool(new_s), m
        if not bool(new_s):
            assert int(slot_b[m]) == int(slot_s), m


def test_gate_batch_ml_mode():
    from ekf_slam_tpu.config import EKFParams
    from ekf_slam_tpu.ops.association import gate, gate_batch
    p = EKFParams(capacity=8, association="ml", s_cost=1e6, s_thresh=50.0,
                  ref_compat=False, dtype=jnp.float64)
    state, _ = make_pair(3, seed=12)
    rng = np.random.default_rng(5)
    z = measurement_of(state, 1, noise=0.02, rng=rng)
    z[2] = 2.0
    R = np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0])
    new_b, slot_b = gate_batch(state, jnp.asarray(z)[None],
                               jnp.asarray(R)[None], p)
    new_s, slot_s, _ = gate(state, jnp.asarray(z), jnp.asarray(R), p)
    assert bool(new_b[0]) == bool(new_s)
    if not bool(new_s):
        assert int(slot_b[0]) == int(slot_s)


def test_measure_batched_capacity_full_drops_new():
    """At capacity, new-landmark observations become no-ops (masked
    append), matching the sequential path's guard."""
    state, _ = make_pair(8)            # capacity 8, full
    u = jnp.array([0.05, 2.0])
    obs = obs_from_rows([[1.0, 45.0, 99]], [[0.7, 0.7]], PARAMS.max_obs,
                        jnp.float64)
    out = batched.measure_batched(state, obs, u, PARAMS)
    assert int(out.n_active) == 8
    assert np.all(np.isfinite(np.asarray(out.P)))


def test_joint_update_is_permutation_equivariant():
    """The joint rank-2M update must not depend on observation order
    within the batch (the algebra is permutation-equivariant; this is
    also what licenses in-chunk reorderings like the sorted-gather
    experiment).  Checked for the dense gemm path, rows mode, and the
    factor-space Andrews update."""
    import dataclasses

    from ekf_slam_tpu.models import srekf, srekf_fast

    state, _ = make_pair(5, seed=17)
    rng = np.random.default_rng(5)
    zs, Rs = [], []
    slots_l = [0, 3, 1, 4, 2]
    for slot in slots_l:
        z = measurement_of(state, slot, noise=0.02, rng=rng)
        zs.append(z)
        Rs.append(np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0]))
    zs = jnp.asarray(np.stack(zs))
    Rs = jnp.asarray(np.stack(Rs))
    slots = jnp.asarray(slots_l)
    valid = jnp.asarray([True, True, False, True, True])
    perm = jnp.asarray([4, 2, 0, 3, 1])

    for name, params in (
            ("gemm", PARAMS),
            ("rows", dataclasses.replace(PARAMS, pht_mode="rows"))):
        a = batched.update_batch(state, zs, slots, Rs, valid, params)
        b = batched.update_batch(state, zs[perm], slots[perm], Rs[perm],
                                 valid[perm], params)
        np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x),
                                   rtol=1e-11, atol=1e-13, err_msg=name)
        np.testing.assert_allclose(np.asarray(a.P), np.asarray(b.P),
                                   rtol=1e-10, atol=1e-12, err_msg=name)

    sr = srekf.factor_from_state(state)
    sa = srekf_fast.sr_update_andrews(sr, zs, slots, Rs, valid, PARAMS)
    sb = srekf_fast.sr_update_andrews(sr, zs[perm], slots[perm], Rs[perm],
                                      valid[perm], PARAMS)
    np.testing.assert_allclose(np.asarray(sa.x), np.asarray(sb.x),
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(np.asarray(sa.P @ sa.P.T),
                               np.asarray(sb.P @ sb.P.T),
                               rtol=1e-10, atol=1e-12)


def test_gate_batch_ml_unique_mutual_exclusion():
    """association='ml_unique': a landmark accepts only its best claimant
    per batch; the out-claimed observation becomes a new candidate, ties
    break to the lowest observation index, and singleton associations
    match plain ML exactly."""
    import dataclasses

    from ekf_slam_tpu.ops.association import gate_batch

    state, _ = make_pair(3, seed=7)
    rng = np.random.default_rng(2)
    z_close = measurement_of(state, 1, noise=0.001, rng=rng)
    z_far = measurement_of(state, 1, noise=0.001, rng=rng)
    z_far[0] += 0.2                       # same landmark, worse claim
    z_other = measurement_of(state, 2, noise=0.001, rng=rng)
    zs = jnp.asarray(np.stack([z_far, z_close, z_other]))
    Rs = jnp.asarray(np.tile(np.diag([0.05, 1.0]), (3, 1, 1)))

    ml = dataclasses.replace(PARAMS, association="ml", s_cost=1e6,
                             s_thresh=50.0)
    mlu = dataclasses.replace(ml, association="ml_unique")

    is_new0, slot0 = gate_batch(state, zs, Rs, ml)
    assert not bool(is_new0.any())
    assert slot0.tolist() == [1, 1, 2]    # double association under ML

    is_new1, slot1 = gate_batch(state, zs, Rs, mlu)
    assert is_new1.tolist() == [True, False, False]   # loser → new
    assert slot1.tolist()[1:] == [1, 2]

    # exact tie: lowest observation index wins
    zs_tie = jnp.asarray(np.stack([z_close, z_close]))
    Rs_tie = Rs[:2]
    is_new2, _ = gate_batch(state, zs_tie, Rs_tie, mlu)
    assert is_new2.tolist() == [False, True]

    # return_losers identifies exactly the out-claimed rows (and is
    # all-False under plain ML, where no exclusion happens)
    is_new3, _, losers3 = gate_batch(state, zs, Rs, mlu,
                                     return_losers=True)
    assert is_new3.tolist() == is_new1.tolist()
    assert losers3.tolist() == [True, False, False]
    _, _, losers_ml = gate_batch(state, zs, Rs, ml, return_losers=True)
    assert not bool(losers_ml.any())


def test_ml_unique_loser_semantics_append_vs_drop():
    """Two in-batch observations of the same landmark: with the default
    ml_losers='append' the loser is APPENDED as a duplicate landmark;
    with ml_losers='drop' it is invalidated for the batch — no duplicate,
    and the posterior equals processing the winner alone."""
    import dataclasses

    from ekf_slam_tpu.ops.observations import ObsBatch

    state, _ = make_pair(3, seed=11)
    rng = np.random.default_rng(5)
    z_win = measurement_of(state, 1, noise=0.001, rng=rng)
    z_lose = measurement_of(state, 1, noise=0.001, rng=rng)
    z_lose[0] += 0.2
    u = jnp.zeros((2,), jnp.float64)

    def obs_of(zrows):
        zrows = np.stack(zrows)
        m = zrows.shape[0]
        return ObsBatch(
            rng=jnp.asarray(zrows[:, 0]), bearing=jnp.asarray(zrows[:, 1]),
            index=jnp.asarray(zrows[:, 2], jnp.int32),
            loc=jnp.zeros((m, 2), jnp.float64), valid=jnp.ones((m,), bool))

    mlu = dataclasses.replace(PARAMS, association="ml_unique",
                              s_cost=1e6, s_thresh=50.0,
                              update_mode="batched")
    n0 = int(state.n_active)

    out_append = batched.measure_batched(state, obs_of([z_lose, z_win]),
                                         u, mlu)
    assert int(out_append.n_active) == n0 + 1      # duplicate appended

    drop = dataclasses.replace(mlu, ml_losers="drop")
    out_drop = batched.measure_batched(state, obs_of([z_lose, z_win]),
                                       u, drop)
    assert int(out_drop.n_active) == n0            # loser dropped
    ref = batched.measure_batched(state, obs_of([z_win]), u, drop)
    np.testing.assert_allclose(np.asarray(out_drop.x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(out_drop.P), np.asarray(ref.P),
                               rtol=1e-12, atol=1e-14)


def test_session_with_ml_unique_association():
    """ml_unique end-to-end through the batched session: runs, maps, and
    with well-separated sim landmarks matches the ml session."""
    from ekf_slam_tpu.config import EKFParams
    from ekf_slam_tpu.session import SlamSession
    from test_sim_session import SIM_RANSAC, make_traj

    traj, _ = make_traj(T=30)
    common = dict(capacity=16, max_obs=8, ref_compat=False,
                  update_mode="batched", dtype=jnp.float64,
                  association="ml", s_cost=1e6, s_thresh=1e3)
    a = SlamSession(ekf_params=EKFParams(**common),
                    ransac_params=SIM_RANSAC, seed=1)
    common["association"] = "ml_unique"
    b = SlamSession(ekf_params=EKFParams(**common),
                    ransac_params=SIM_RANSAC, seed=1)
    ca, oa = a.run(traj.odom, traj.ranges, traj.beam_angles)
    cb, ob = b.run(traj.odom, traj.ranges, traj.beam_angles)
    # under this loose gate plain ML COLLAPSES the map: every wall foot
    # associates to the first landmark and the map never grows past it —
    # exactly the contention failure the unique gate exists to prevent
    assert int(ca.filt.n_active) == 1
    assert int(cb.filt.n_active) == 4      # all four walls mapped
    assert np.isfinite(np.asarray(ob.pose)).all()
