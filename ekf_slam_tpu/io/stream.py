"""Real-time streaming SLAM driver — the reference's live operating mode.

The reference's only mode is a blocking receive loop: ``while(1)
s.runSlam()`` over ``receive(laser)`` / ``receive(odom)``
(test_SLAM.m:16-18, SLAM.m:73-74).  A per-tick port of that loop pays the
fixed cost of one program dispatch (and one host round trip) on every
tick, however fast the filter math is.  This driver amortizes it:

* **micro-batching** — arriving ticks accumulate into a window of W
  ticks; each full window runs as ONE device program (the session's fused
  ``lax.scan``), so the dispatch cost is paid once per W ticks;
* **double-buffered async dispatch** — JAX dispatch is asynchronous and
  the session carry chains device-to-device, so window k+1 is dispatched
  while window k is still computing; the host only blocks when it *reads*
  results (or when ``max_pending`` backpressure kicks in);
* **per-tick latency accounting** — arrival → result-ready wall time per
  tick (p50/p99/mean), the metric a live robot cares about.  Steady-state
  latency ≈ window fill time (W/rate) + one program time; throughput ≈
  W / (dispatch + W·per-tick-compute).

Optionally composes with elastic recovery (utils/recovery.py): a
checkpoint of the full session carry every ``checkpoint_every`` windows is
the live loop's heartbeat snapshot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class StreamStats:
    """Latency/throughput accounting for a streaming run."""
    n_ticks: int = 0
    t_first_arrival: Optional[float] = None
    t_last_done: Optional[float] = None
    latencies: List[float] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies, np.float64)
        dur = ((self.t_last_done - self.t_first_arrival)
               if self.n_ticks and self.t_first_arrival is not None else 0.0)
        return {
            "ticks": float(self.n_ticks),
            "ticks_per_sec": self.n_ticks / dur if dur > 0 else float("inf"),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3)
            if lat.size else 0.0,
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3)
            if lat.size else 0.0,
            "latency_mean_ms": float(lat.mean() * 1e3) if lat.size else 0.0,
        }


class StreamingSlamSession:
    """Live host-feed driver over a ``session.SlamSession``.

    ``push(odom_pose, ranges)`` per arriving tick; completed per-tick
    outputs come back from ``push``/``poll``/``flush`` in arrival order.
    ``window`` ticks form one fused device program; up to ``max_pending``
    windows are in flight before the host blocks (backpressure).
    """

    def __init__(self, session, n_beams: int, beam_angles,
                 window: int = 8, max_pending: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 8, first_odom=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.session = session
        self.window = window
        self.max_pending = max(1, max_pending)
        self.beam_angles = jnp.asarray(beam_angles)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.carry = session.init_carry(
            first_odom=first_odom,
            n_beams=(n_beams if session.control_source in ("icp", "fused")
                     else None))
        self._buf_odom: List[np.ndarray] = []
        self._buf_rng: List[np.ndarray] = []
        self._buf_arrival: List[float] = []
        # in-flight windows: (outs_future, arrival_times)
        self._pending: List[Tuple[Any, List[float]]] = []
        # completed per-tick outputs not yet handed to the caller
        self._ready: List[Any] = []
        self._windows_done = 0
        self._tick = 0
        self.stats = StreamStats()

    # -- feed ---------------------------------------------------------------
    def push(self, odom_pose, ranges, t_arrival: Optional[float] = None
             ) -> List[Any]:
        """Feed one tick (the ``receive`` seam, SLAM.m:73-74); returns any
        per-tick outputs that completed, in arrival order."""
        now = time.perf_counter() if t_arrival is None else t_arrival
        if self.stats.t_first_arrival is None:
            self.stats.t_first_arrival = now
        dt = self.session.ekf_params.dtype
        self._buf_odom.append(np.asarray(odom_pose, dt))
        self._buf_rng.append(np.asarray(ranges, dt))
        self._buf_arrival.append(now)
        self._tick += 1
        if len(self._buf_odom) >= self.window:
            self._dispatch()
        return self.poll(block=False)

    def _dispatch(self):
        """Launch the buffered ticks as one async device program."""
        if not self._buf_odom:
            return
        odom = jnp.asarray(np.stack(self._buf_odom))
        rng = jnp.asarray(np.stack(self._buf_rng))
        arrivals = self._buf_arrival
        self._buf_odom, self._buf_rng, self._buf_arrival = [], [], []
        # async: returns immediately, carry chains on device into the
        # next window's program (double buffering)
        self.carry, outs = self.session._run(self.carry, odom, rng,
                                             self.beam_angles)
        self._pending.append((outs, arrivals))
        # backpressure: bound device queue depth
        while len(self._pending) > self.max_pending:
            self._drain_one(block=True)

    # -- results ------------------------------------------------------------
    def _drain_one(self, block: bool) -> bool:
        """Move the oldest in-flight window to the ready queue.  Returns
        whether a window completed."""
        if not self._pending:
            return False
        outs, arrivals = self._pending[0]
        if not block and not outs.pose.is_ready():
            return False
        # ONE host transfer per window, sliced in numpy: per-tick device
        # slicing (outs.pose[i] etc.) would dispatch a tiny device program
        # per leaf per tick — the per-program cost the windowing exists
        # to amortize.
        outs = jax.device_get(outs)
        done = time.perf_counter()
        self._pending.pop(0)
        self.stats.t_last_done = done
        self.stats.n_ticks += len(arrivals)
        self.stats.latencies.extend(done - a for a in arrivals)
        self._windows_done += 1
        if (self.checkpoint_dir is not None
                and self._windows_done % self.checkpoint_every == 0):
            from ..utils.checkpointing import save_checkpoint
            save_checkpoint(self.checkpoint_dir, self.carry,
                            step=self.stats.n_ticks)
        self._ready.extend(
            jax.tree_util.tree_map(lambda a: np.asarray(a)[i], outs)
            for i in range(len(arrivals)))
        return True

    def reset_stats(self) -> None:
        """Restart latency/throughput accounting (e.g. after a warm-up
        pass whose compile time is not a latency statement)."""
        self.stats = StreamStats()

    def poll(self, block: bool = False) -> List[Any]:
        """Collect completed per-tick outputs (non-blocking by default)."""
        while self._drain_one(block=block):
            block = False     # only force at most one blocking wait
        out, self._ready = self._ready, []
        return out

    def flush(self) -> List[Any]:
        """Dispatch any partial window and block for everything in flight.

        The remainder runs as its own (smaller) fused program — compiled
        once per distinct remainder length."""
        self._dispatch()
        while self._pending:
            self._drain_one(block=True)
        out, self._ready = self._ready, []
        return out
