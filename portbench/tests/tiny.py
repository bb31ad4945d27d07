"""A cell small enough for the CPU: 200 landmarks (D 512), the cells' own
configurations and request length, plain versions of the port's kernels."""

TINY = {"chips": 1, "world": {"landmarks": 200, "seed": 42, "extent": 3000.0},
        "request_frames": 17, "rollout_frames": 3000, "sample_within": 3, "sampled_requests": 2,
        "trace_after_s": 0.0, "trace_requests": 1}


def tiny(config: str, **kw) -> dict:
    """The tiny cell of ``config`` ("ekf_known" or "ekf_gated") with the
    known cells' covariance limit."""
    from portbench import harness

    limits = harness.load("traffic", "known.lm10k")["limits"]
    return {**TINY, "config": config, "capacity": 300, "limits": limits, **kw}
