"""Elastic recovery: kill a checkpointed session mid-run, resume from the
snapshot in a fresh session object, and prove trajectory continuity.

SURVEY.md §5: "heartbeat + checkpointed filter state so a restarted host
rejoins from the last keyframe" — the behavior the reference cannot have
(its state dies with the workspace, test_SLAM.m:5).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.session import SlamSession
from ekf_slam_tpu.utils import recovery
from ekf_slam_tpu.utils.faults import corrupt_odometry

from test_sim_session import SIM_RANSAC, make_traj

import jax


def make_session(seed=1, guard=None):
    return SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(capacity=16, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=jnp.float64,
                             guard_max_jump=guard),
        ransac_params=SIM_RANSAC, seed=seed)


def test_crash_resume_is_bit_continuous(tmp_path):
    """Kill at tick 47 (checkpoints every 20 → last snapshot at 40); a
    FRESH session resumes from the snapshot and replays the tail.  The
    final state must match an uninterrupted checkpointed run exactly —
    the carry is the session's entire dynamic state."""
    traj, _ = make_traj(T=80)
    odom, ranges, beams = traj.odom, traj.ranges, traj.beam_angles

    # uninterrupted run (same chunking so the scan boundaries align)
    ref_dir = str(tmp_path / "ref")
    ref_carry, ref_poses, _ = recovery.run_with_checkpoints(
        make_session(), odom, ranges, beams, ref_dir, every=20)

    # crashing run: dies mid-chunk at tick 47, losing ticks 40-47
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(recovery.HostCrash):
        recovery.run_with_checkpoints(
            make_session(), odom, ranges, beams, crash_dir, every=20,
            die_at_tick=47)

    # restarted "host": fresh session object, same config, resumes
    final, tail_poses, start = recovery.resume_latest(
        make_session(), odom, ranges, beams, crash_dir, every=20)
    assert start == 40

    np.testing.assert_allclose(np.asarray(final.filt.x),
                               np.asarray(ref_carry.filt.x),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(final.filt.P),
                               np.asarray(ref_carry.filt.P),
                               rtol=0, atol=0)
    assert int(final.filt.n_active) == int(ref_carry.filt.n_active)
    np.testing.assert_array_equal(np.asarray(final.key),
                                  np.asarray(ref_carry.key))
    # the replayed tail reproduces the reference trajectory exactly
    np.testing.assert_allclose(np.asarray(tail_poses),
                               np.asarray(ref_poses[40:]),
                               rtol=0, atol=0)


def test_recovery_composes_with_fault_injection(tmp_path):
    """Full failure story: corrupted odometry mid-stream (wheel-slip
    outliers, utils/faults.py) absorbed by the fused ICP/odometry control
    + the in-jit rollback guard + crash/resume — the resumed session
    still tracks within the ATE bound."""
    traj, _ = make_traj(T=80)
    key = jax.random.PRNGKey(7)
    bad_odom = corrupt_odometry(jnp.asarray(traj.odom), key, p_tick=0.05,
                                magnitude=3.0)

    def fused_session(seed=1):
        return SlamSession(
            algorithm="EKF_SLAM_UC",
            ekf_params=EKFParams(capacity=16, max_obs=8, ref_compat=False,
                                 update_mode="batched", dtype=jnp.float64,
                                 guard_max_jump=1.0),
            ransac_params=SIM_RANSAC, seed=seed,
            control_source="fused", icp_iters=15, icp_max_pair_dist=0.5)

    crash_dir = str(tmp_path / "faulty")
    with pytest.raises(recovery.HostCrash):
        recovery.run_with_checkpoints(
            fused_session(), bad_odom, traj.ranges, traj.beam_angles,
            crash_dir, every=16, die_at_tick=50)

    final, _, start = recovery.resume_latest(
        fused_session(), bad_odom, traj.ranges, traj.beam_angles,
        crash_dir, every=16)
    assert start == 48
    assert np.all(np.isfinite(np.asarray(final.filt.x)))
    # scan-to-scan ICP masks the odometry outliers (fused control), the
    # guard bounds anything that slips through, and crash+resume keeps
    # the trajectory continuous — end pose stays near truth.
    pose = np.asarray(final.filt.x[:2])
    truth = np.asarray(traj.truth[-1, :2])
    assert np.linalg.norm(pose - truth) < 0.75, (pose, truth)


def test_donated_session_crash_resume_bit_continuous(tmp_path):
    """Checkpoint/resume in the SINGLE-BUFFER regime: the session donates
    its carry to the step program (the capacity-ceiling mode, where P has
    one buffer and the input carry is
    CONSUMED) — recovery.drive_ticks snapshots the carry to host BEFORE
    each donating step, so a crash still resumes bit-continuously."""
    traj, _ = make_traj(T=60)
    odom, ranges, beams = traj.odom, traj.ranges, traj.beam_angles

    def donated_session(seed=1):
        s = SlamSession(
            algorithm="EKF_SLAM_UC",
            ekf_params=EKFParams(capacity=16, max_obs=8, ref_compat=False,
                                 update_mode="batched", dtype=jnp.float64),
            ransac_params=SIM_RANSAC, seed=seed, donate_carry=True)
        assert s.donate_carry is True
        return s

    ref_dir = str(tmp_path / "ref")
    ref_carry, ref_poses, _ = recovery.drive_ticks(
        donated_session(), odom, ranges, beams, ref_dir, every=20)

    crash_dir = str(tmp_path / "crash")
    with pytest.raises(recovery.HostCrash):
        recovery.drive_ticks(donated_session(), odom, ranges, beams,
                             crash_dir, every=20, die_at_tick=47)

    final, tail, start = recovery.resume_latest_ticks(
        donated_session(), odom, ranges, beams, crash_dir, every=20)
    assert start == 40
    np.testing.assert_allclose(np.asarray(final.filt.x),
                               np.asarray(ref_carry.filt.x),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(final.filt.P),
                               np.asarray(ref_carry.filt.P),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(tail),
                               np.asarray(ref_poses[40:]),
                               rtol=0, atol=0)


def test_resume_without_checkpoint_raises(tmp_path):
    traj, _ = make_traj(T=10)
    with pytest.raises(FileNotFoundError):
        recovery.resume_latest(make_session(), traj.odom, traj.ranges,
                               traj.beam_angles, str(tmp_path / "empty"))
