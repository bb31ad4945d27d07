"""Static configuration of the vehicle, sensor, noise and filter.

Field for field the reference's ``conan_slam_tpu.config.SlamConfig`` (the
port carries its own copy so that it imports nothing of the JAX package;
tests/test_torch_core_models.py holds the two to the same fields and
defaults).  Every default reproduces the reference C++ driver's canonical
values (reference slam.h:63-103, test/main.cpp:93-129).
"""

from __future__ import annotations

import dataclasses
import math


_PI = math.pi


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Static configuration of the vehicle, sensor, noise and filter.

    All angles are radians, distances metres, times seconds.
    """

    # --- vehicle (reference slam.h:65-69) ---
    velocity: float = 83.33                   # m/s
    max_swa: float = _PI / 4.0                # max steering wheel angle [rad]
    rate_swa: float = 70.0 * _PI / 180.0      # max steering rate [rad/s]
    wheel_base: float = 73.0                  # m
    dt_controls: float = 0.01                 # control period [s]

    # --- control noise (reference slam.h:72-73) ---
    sigma_v: float = 0.3                      # m/s
    sigma_swa: float = 1.0 * _PI / 180.0      # rad

    # --- sensor (reference slam.h:76-81) ---
    max_range: float = 2000.0                 # m
    dt_observe: float = 5.058 * 0.01          # observation period [s]
    sigma_r: float = 0.1                      # m
    sigma_b: float = 1.0 * _PI / 180.0        # rad

    # --- data-association gates (reference slam.h:84-85) ---
    gate_reject: float = 50.0                 # NIS gate for association
    gate_augment: float = 1000.0              # NIS gate for new features

    # --- waypoint following (reference slam.h:88-89) ---
    at_waypoint: float = 1.0                  # waypoint switch radius [m]
    number_loops: int = 1                     # loops through waypoint list

    # --- particle filter (reference slam.h:92-93) ---
    num_particles: int = 100
    # Fraction of particles below which we resample; the reference freezes the
    # absolute count at construction (0.75*100, a defect when num_particles is
    # changed later, SURVEY.md defect 10) — we keep it a live fraction.
    effective_fraction: float = 0.75

    # --- behaviour switches (reference slam.h:96-103) ---
    switch_control_noise: bool = True
    switch_sensor_noise: bool = True
    switch_inflate_noise: bool = True
    switch_heading_known: bool = True
    switch_association_known: bool = True
    switch_batch_update: bool = True
    switch_sample_proposal: bool = True
    switch_resample: bool = True
    # Reference-faithful iterated proposal fusion (order-dependent scan,
    # PF.cpp:513-531) vs the default one-shot information-form fusion
    # (batched; a valid proposal — importance weights stay exact).
    proposal_relinearize: bool = False
    # Resampling scheme: "stratified" (reference semantics, defect-fixed) or
    # "systematic" (low-variance).  ``pf_roughening`` > 0 adds Gordon-style
    # post-resample pose jitter against sample impoverishment (robustness
    # extensions; no reference analogue).
    pf_resample_kind: str = "stratified"
    pf_roughening: float = 0.0

    # --- filter noise inflation factors (reference test/main.cpp:125-129,
    # 242-246: QE=2Q for both filters; RE=8R for EKF, RE=2R for PF) ---
    q_inflate: float = 2.0
    r_inflate_ekf: float = 8.0
    r_inflate_pf: float = 2.0

    # --- heading pseudo-observation noise (reference EKF.cpp:337, PF.cpp:391) ---
    sigma_heading: float = 0.01 * _PI / 180.0

    # --- static capacities (no reference analogue: the reference resizes
    # its state dynamically, EKF.cpp:41/69) ---
    max_landmarks: int = 32                   # EKF map slot capacity K
    # Measurement-buffer size (simultaneously visible returns). 0 = size the
    # buffer to the world's landmark count.
    max_obs: int = 0
    # The reference's schedule switches.  runner.loop.run_ekf_slam honours
    # them (the fused frame only with all three of fast_frame, fused_obs
    # and switch_batch_update); the precomputed driver always runs the
    # fused frame, as the reference's does.  ``scan_unroll`` has no
    # counterpart in a Python frame loop.
    fast_frame: bool = True
    fused_obs: bool = True
    scan_unroll: int = 1
    # New-feature augmentation in the frame step.  False for steady-state
    # full-map workloads (n_active == capacity), where augment is a
    # guaranteed no-op.
    enable_augment: bool = True
    # Two consecutive frames per covariance pass (ops.frame_kernel.
    # frame_step_pair), where runner.loop can pair them: known association,
    # augment off and an even number of frames.
    frame_pair: bool = False
    # Wire format of the sharded frame's gain all-gather
    # (parallel.dist_fastframe): "f32" exact, "i16" half the bytes.
    dist_gain_wire: str = "f32"

    @property
    def num_effective(self) -> float:
        """The particle filter's resampling threshold on Neff."""
        return self.effective_fraction * self.num_particles

    @property
    def observe_interval(self) -> int:
        """Number of control steps between observation updates.

        The reference accumulates ``dtsum`` and observes when it reaches
        ``dt_observe`` (test/main.cpp:171-174), which for the default
        dt=0.01, dt_observe=0.05058 fires every 6th step.
        """
        return int(math.ceil(self.dt_observe / self.dt_controls - 1e-9))

    def max_observations(self) -> int:
        """Effective measurement-buffer cap (callers min() with world size)."""
        return self.max_obs if self.max_obs > 0 else 1_000_000_000

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

