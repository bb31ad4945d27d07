"""Estimation engines (the EKF's known-association frame so far)."""
