"""Estimation engines: the EKF (``filters.ekf``) and FastSLAM 2.0 (``filters.pf``)."""
