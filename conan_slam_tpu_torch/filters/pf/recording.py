"""Holding two FastSLAM 2.0 runs to each other one frame at a time: a
``resample_fn`` for ``observation_step`` that records each resampling's
inputs and decision (and can replay the frame on another run's ancestors),
and the rule that says whether a resampling flip between the two is
explained by their weights' difference.

Two float32 runs of the same frame weight their particles a few ulps
apart, so where a stratum's uniform lies that close to a cumulative-weight
boundary (or Neff that close to the threshold) they resample on other
ancestors, and from then on are different realizations.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.filters.pf.resample import (
    cumulative_weights,
    effective_count,
    resample,
    resample_ancestors,
    stratified_indices,
    systematic_indices,
)
from conan_slam_tpu_torch.filters.pf.state import normalized_weights


def recording(seen: dict, force: tuple[torch.Tensor, bool] | None = None):
    """A ``resample_fn`` that records, on the CPU, the normalised weights
    ``w``, ``neff``, the uniforms ``u``, the ancestors ``idx`` it would draw
    and the ``gate`` in ``seen``, then resamples; with ``force=(idx, fire)``
    it resamples on those ancestors where ``fire`` (and the gate) hold
    instead.  It waits on the device: a checking hook, not the loop's."""
    def hook(ens, u, rough, num_effective, enabled, kind="stratified", roughening=0.0,
             gate=None):
        w = normalized_weights(ens)
        pick = systematic_indices if kind == "systematic" else stratified_indices
        seen.update(w=w.cpu(), neff=float(effective_count(w)), u=u.cpu(),
                    idx=pick(u, w, ens.num_particles).cpu(), gate=bool(gate))
        if force is None:
            return resample(ens, u, rough, num_effective, enabled, kind=kind,
                            roughening=roughening, gate=gate)
        if not enabled:
            return ens
        fire = torch.tensor(force[1], device=ens.pose.device)
        if gate is not None:
            fire = fire & gate
        return resample_ancestors(ens, force[0].to(ens.pose.device), fire, rough, roughening)
    return hook


def resampling_flip(seen: dict, other: dict, threshold: float) -> list[tuple[str, float, float]]:
    """How two records of one frame's resampling (``recording``'s ``seen``)
    disagree, as ``(what, margin, difference)`` items, none where they
    agree: the decision, with by how much ``seen``'s Neff missed
    ``threshold`` and the two Neffs' difference; or each stratum drawn from
    other ancestors, with by how much its point (i + u) / N missed the first
    cumulative-weight boundary between them, |u - cum|, and the two
    cumulative weights' difference there.  The flip is explained where
    each margin is at most its difference."""
    fire = seen["gate"] and seen["neff"] < threshold
    fire_other = other["gate"] and other["neff"] < threshold
    if fire != fire_other:
        return [(f"Neff {seen['neff']:.4f} (other {other['neff']:.4f})",
                 abs(seen["neff"] - threshold), abs(seen["neff"] - other["neff"]))]
    if not fire or torch.equal(seen["idx"], other["idx"]):
        return []
    n = seen["idx"].shape[0]
    strata = (torch.arange(n, dtype=seen["w"].dtype) + seen["u"]) / n
    cum, cum_other = cumulative_weights(seen["w"]), cumulative_weights(other["w"])
    out = []
    for i in torch.nonzero(seen["idx"] != other["idx"])[:, 0].tolist():
        j = min(int(seen["idx"][i]), int(other["idx"][i]))
        out.append((f"stratum {i}", float((strata[i] - cum[j]).abs()),
                    float((cum[j] - cum_other[j]).abs())))
    return out
