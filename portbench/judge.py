"""The comparison that decides ``correct``: the program's requests against
the plain reference (``reference/ekf.py``) in float64.

A sampled request is replayed by the reference from the state the program
started it from (request 0 from the benchmark's own start state), over the
same log slice and noise draws, and judged on:

* ``cov_gap``: the widest gap of the request's end covariance, each entry
  against the reference's, as a share of sqrt(P_ii P_jj) (the scale of the
  entry's own correlation); an entry where the reference's variance is 0
  (a slot not in use) has to be 0;
* ``pose_gap_m``: the widest gap in metres of the estimated position at
  each control step of the request (the answers the client reads);
* ``map_mismatch``: the map's bookkeeping, exact: steps whose map size
  differs, landmark ids whose slot differs at the request's end, and
  landmarks the two map in different frames.

On the gated path a return whose gate decision a 1% change of the gates, or
of the order of two candidates' scores, would flip is a tie that rounding
may decide either way: the reference tries each way (at most three such
returns a frame) and keeps the one that agrees with what the program
mapped in that frame and then with its pose at the frame's end.  The
number of ties is reported, not judged.
"""

from __future__ import annotations

import itertools
import math
import sys

import torch

from portbench.reference.ekf import Filter, Frame, State

MAX_TIES = 3


def cov_gap(p_prog: torch.Tensor, p_ref: torch.Tensor, rows: int = 1024) -> float:
    """max_ij |P_prog - P_ref| / sqrt(P_ref_ii P_ref_jj), in blocks of rows;
    where that scale is 0 the program's entry has to be exactly 0."""
    sd = torch.sqrt(torch.clamp(torch.diagonal(p_ref), min=0.0))
    worst = 0.0
    for r0 in range(0, p_ref.shape[0], rows):
        diff = (p_prog[r0:r0 + rows].to(p_ref.dtype) - p_ref[r0:r0 + rows]).abs()
        scale = sd[r0:r0 + rows, None] * sd[None, :]
        off = (scale == 0) & (diff != 0)
        if bool(off.any()):
            return math.inf
        gap = torch.where(scale > 0, diff / torch.where(scale > 0, scale, 1.0), 0.0)
        worst = max(worst, float(gap.max()))
    return worst


def replay(filt: Filter, start: State, frames: list[Frame], prog: dict | None):
    """The reference over ``frames`` from ``start`` (replaced).  With
    ``prog`` (the program's x_est, n_active and end table) ties are
    resolved toward it.  Returns (state, poses (F*S, 3), n_active per step,
    landmarks mapped per frame, ties)."""
    st = start
    poses, sizes, mapped, ties, gate_nis = [], [], [], 0, []
    for f, fr in enumerate(frames):
        choose = None
        if prog is not None:
            before = st.n_active if f == 0 else int(prog["n_active"][f * fr.swa.shape[0] - 1])
            after = int(prog["n_active"][(f + 1) * fr.swa.shape[0] - 1])
            slot = prog["table"]
            prog_new = set(torch.nonzero((slot >= before) & (slot < after)).flatten().tolist())
            pose_end = prog["x_est"][(f + 1) * fr.swa.shape[0] - 1, :2].to(st.x.dtype)

            def choose(alts, resolve, prog_new=prog_new, pose_end=pose_end):
                items = sorted(alts.items())[:MAX_TIES]
                best = None
                for picks in itertools.product(*[[None, *a] for _, a in items]):
                    override = {i: d for (i, _), d in zip(items, picks) if d is not None}
                    trial, got = resolve(override)
                    score = (len(set(got) ^ prog_new),
                             float(torch.linalg.norm(trial.x[:2] - pose_end)))
                    if best is None or score < best[0]:
                        best = (score, trial, got)
                    else:
                        del trial
                return best[1], best[2]
        pose, got, n_ties = filt.frame(st, fr, choose)
        ties += n_ties
        poses.append(pose)
        sizes += [st.n_active] * fr.swa.shape[0]
        mapped.append(set(got))
        gate_nis.append(filt.last_min_nis)
    return st, torch.cat(poses), sizes, mapped, ties, gate_nis


def judge(filt: Filter, start: State, frames: list[Frame], prog: dict) -> dict:
    """The numbers of one request: ``prog`` holds the program's ``x_est``
    (F*S, 3), ``n_active`` (F*S,), and its end ``x``, ``p``, ``table``."""
    n0 = start.n_active
    st, poses, sizes, mapped, ties, gate_nis = replay(filt, start, frames, prog)
    s_steps = frames[0].swa.shape[0]
    n_prog = [int(v) for v in prog["n_active"]]
    mism = sum(a != b for a, b in zip(sizes, n_prog))
    mism += int((st.table != prog["table"].to(st.table.device)).sum())
    for f, got in enumerate(mapped):
        before = n0 if f == 0 else n_prog[f * s_steps - 1]
        after = n_prog[(f + 1) * s_steps - 1]
        slot = prog["table"]
        want = set(torch.nonzero((slot >= before) & (slot < after)).flatten().tolist())
        if want ^ got:
            mism += len(want ^ got)
            ids = frames[f].ids.tolist()
            nis = gate_nis[f]
            why = {i: None if nis is None or i not in ids else float(nis[ids.index(i)])
                   for i in sorted(want ^ got)}
            print(f"judge: frame {f} of the request maps {sorted(want - got)} in the program and "
                  f"{sorted(got - want)} in the reference; the reference's least NIS of each "
                  f"return: {why}", file=sys.stderr)
    pose_gap = float(torch.linalg.norm(poses[:, :2] - prog["x_est"][:, :2].to(poses), dim=1).max())
    return {"cov_gap": cov_gap(prog["p"], st.p), "pose_gap_m": pose_gap,
            "map_mismatch": float(mism), "ties": float(ties)}
