"""The control: the plain reference put in the program's place, in the
precision one step below the configuration's (TF32 products for float32
with TF32 off), behind the replay driver's interface.  A run with it has to
come out not correct (``calibrate.py`` reads its numbers; the harness's own
runs never use it)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.ekf import Filter, Frame, State


class Outs(NamedTuple):
    x_est: torch.Tensor
    n_active: torch.Tensor


def driver(nums: dict, precision: str = "tf32"):
    """A function with ``run_ekf_slam_precomputed``'s call that runs the
    reference in ``precision`` and returns its state in the program's
    state type."""
    filt = Filter({**nums, "tie_rel": 0.0}, precision)

    def run(world, cfg, generator, n_steps, init_state, precomputed, *, ctrl_noise, obs_noise):
        (x_true, swa, active, done), (z, ids, mask) = precomputed
        s = cfg.observe_interval
        st = State(init_state.x.to(filt.dtype).clone(), init_state.p.to(filt.dtype).clone(),
                   int(init_state.n_active), init_state.table.clone())
        act, dn = active.cpu().tolist(), done.cpu().tolist()
        poses, sizes = [], []
        for f in range(n_steps // s):
            fr = Frame(x_true[f * s:(f + 1) * s], swa[f * s:(f + 1) * s], act[f * s:(f + 1) * s],
                       dn[(f + 1) * s - 1], ctrl_noise[f], z[f], ids[f], mask[f], obs_noise[f])
            pose, _, _ = filt.frame(st, fr)
            poses.append(pose.float())
            sizes += [st.n_active] * s
        new = type(init_state)(x=st.x.float(), p=st.p.float(),
                               n_active=torch.tensor(st.n_active, device=st.x.device),
                               table=st.table)
        return new, Outs(torch.cat(poses), torch.tensor(sizes, device=st.x.device))

    return run
