"""Pose-graph back end and front end for loop closure (port of
conan_slam_tpu.graph; BASELINE config 4)."""
