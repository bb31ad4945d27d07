"""World container and the host-side truth/observation rollout."""
