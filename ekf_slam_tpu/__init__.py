"""ekf_slam_tpu — an accelerator-native EKF-SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of SamShue/EKF_SLAM
(2-D feature-based EKF-SLAM: RANSAC wall/landmark extraction, ML data
association, dense joint-covariance EKF), built for fixed-shape jit
compilation, batched association, and covariance tiles sharded over a
device mesh.

Primary entry points::

    from ekf_slam_tpu import SlamSession, EKFParams, RansacParams
    sess = SlamSession("EKF_SLAM_UC", ekf_params=EKFParams(capacity=128))
    carry, outs = sess.run(odom_poses, ranges, beam_angles)

See README.md for the architecture map and PARITY.md for the
reference-component coverage.
"""

from . import config
from .config import (ASSOC_KNOWN, ASSOC_ML, ASSOC_SIGNATURE, EKFParams,
                     MeshConfig, RansacParams, SimConfig, ref_compat_known,
                     ref_compat_legacy, ref_compat_uc)
from .session import ALGORITHMS, EXTRACTORS, SessionCarry, SlamSession
from .state import FilterState, init_state

__version__ = "0.1.0"

__all__ = [
    "config", "EKFParams", "RansacParams", "SimConfig", "MeshConfig",
    "ASSOC_SIGNATURE", "ASSOC_ML", "ASSOC_KNOWN",
    "ref_compat_uc", "ref_compat_known", "ref_compat_legacy",
    "FilterState", "init_state",
    "SlamSession", "SessionCarry", "ALGORITHMS", "EXTRACTORS",
]
