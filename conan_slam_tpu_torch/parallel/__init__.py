"""The sharded runtime on ``torch.distributed`` (port of
conan_slam_tpu.parallel): the mesh, the rank launcher, and the per-rank
sharded EKF, frame, particle filter and runner."""
