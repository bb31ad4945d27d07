"""The plain EKF-SLAM reference: the filter the port runs, written out step
by step in plain PyTorch, with no kernel, no factored frame and no
batching across sub-steps.

It follows the reference C++ driver (mfkiwl/conan-slam test/main.cpp:
89-201, EKF.cpp): each control step a predict (EKF.cpp:406-455) and a
heading observation (EKF.cpp:328-352); each observation frame a batch
update over the associated returns (EKF.cpp:93-129), the association by
the id table (EKF.cpp:169-182) or by Mahalanobis-gated nearest neighbour
(EKF.cpp:235-326), and the augmentation of new features one at a time
(EKF.cpp:9-91).  It imports nothing of the program; the benchmark hands it
the same log, noise draws and start state that it hands the program.

``precision`` is "float64" (the reference) or "tf32" (the control: float32
storage with every matrix product in TF32, the precision one step below
the configuration's float32 with TF32 off).  On the CPU, which has no
TF32, the control rounds each product's operands to TF32's 10-bit
mantissa.
"""

from __future__ import annotations

import itertools
import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch

PRECISIONS = ("float64", "tf32")


@dataclass
class State:
    x: torch.Tensor       # (D,) mean: pose, then two entries a map slot, then padding
    p: torch.Tensor       # (D, D) covariance
    n_active: int         # slots in use
    table: torch.Tensor   # (L,) int64 landmark id -> slot, -1 unmapped

    @property
    def capacity(self) -> int:
        return (self.x.shape[0] - 3) // 2


@dataclass
class Frame:
    """One observation frame of the log: S control steps, then the
    returns at the last one."""

    x_true: torch.Tensor      # (S, 3) true poses (the heading observation reads [:, 2])
    swa: torch.Tensor         # (S,) true steering angles
    active: list              # (S,) the step was driven
    done: bool                # the course is complete at the frame's end
    ctrl_noise: torch.Tensor  # (S, 2) standard normal
    z_true: torch.Tensor      # (NZ, 2) noiseless (range, bearing)
    ids: torch.Tensor         # (NZ,) landmark ids, -1 in empty slots
    mask: torch.Tensor        # (NZ,) bool
    obs_noise: torch.Tensor   # (NZ, 2) standard normal


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to nearest at TF32's 10 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextmanager
def _tf32():
    """TF32 products on the card for the block (the program pins them off)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def wrap(a):
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


class Filter:
    """The filter of one configuration (``cfg``: the configuration file's
    ``vehicle``, ``sensor``, ``noise`` and ``filter`` groups merged) in
    ``precision``."""

    def __init__(self, cfg: dict, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.c = cfg
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    # ------------------------------------------------------------ products

    def mm(self, a, b):
        if self.precision == "float64":
            return a @ b
        if a.is_cuda:
            with _tf32():
                return a @ b
        return _round_tf32(a) @ _round_tf32(b)

    def sub_outer(self, p, w):
        """P -= W W^T for W (D, m)."""
        if self.precision == "tf32" and p.is_cuda:
            with _tf32():
                p.addmm_(w, w.T, alpha=-1.0)
        elif self.precision == "tf32":
            p.sub_(_round_tf32(w) @ _round_tf32(w.T.contiguous()))
        else:
            p.addmm_(w, w.T, alpha=-1.0)

    def t(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    # --------------------------------------------------------------- steps

    def noise_covs(self):
        c = self.c
        q = torch.diag(self.t([c["sigma_v"] ** 2, c["sigma_swa"] ** 2]))
        r = torch.diag(self.t([c["sigma_r"] ** 2, c["sigma_b"] ** 2]))
        if c["switch_inflate_noise"]:
            return c["q_inflate"] * q, c["r_inflate_ekf"] * r
        return q, r

    def predict(self, st: State, v, swa):
        c = self.c
        dt, wb = c["dt_controls"], c["wheel_base"]
        x, p = st.x, st.p
        phi = x[2]
        a = swa + phi
        sa, ca = torch.sin(a), torch.cos(a)
        gv = torch.eye(3, dtype=self.dtype, device=self.device)
        gv[0, 2] = -v * dt * sa
        gv[1, 2] = v * dt * ca
        gu = torch.stack([
            torch.stack([dt * ca, -v * dt * sa]),
            torch.stack([dt * sa, v * dt * ca]),
            torch.stack([dt * torch.sin(swa) / wb, v * dt * torch.cos(swa) / wb]),
        ])
        p[:3, :] = self.mm(gv, p[:3, :])
        p[:, :3] = self.mm(p[:, :3], gv.T)
        p[:3, :3] += self.mm(self.mm(gu, self.qe), gu.T)
        x[:3] = torch.stack([x[0] + v * dt * ca, x[1] + v * dt * sa,
                             wrap(phi + v * dt * torch.sin(swa) / wb)])

    def observe_heading(self, st: State, phi_meas):
        """The heading pseudo-observation, a scalar Kalman update of x[2]:
        P -= P e2 e2^T P / s (the Joseph form's value for a direct
        observation)."""
        x, p = st.x, st.p
        pc = p[:, 2].clone()
        s = pc[2] + self.c["sigma_heading"] ** 2
        x += pc / s * wrap(phi_meas - x[2])
        x[2] = wrap(x[2])
        p.addr_(pc, pc, alpha=-1.0 / float(s))

    def observe(self, pose, feats):
        """Predicted (range, bearing) of ``feats`` (n, 2) from ``pose`` and
        the Jacobian blocks hv (n, 2, 3), hf (n, 2, 2)."""
        dx, dy = feats[:, 0] - pose[0], feats[:, 1] - pose[1]
        d2 = dx * dx + dy * dy
        d = torch.sqrt(d2)
        zp = torch.stack([d, torch.atan2(dy, dx) - pose[2]], -1)
        zero, one = torch.zeros_like(d), torch.ones_like(d)
        hv = torch.stack([torch.stack([-dx / d, -dy / d, zero], -1),
                          torch.stack([dy / d2, -dx / d2, -one], -1)], -2)
        hf = torch.stack([torch.stack([dx / d, dy / d], -1),
                          torch.stack([-dy / d2, dx / d2], -1)], -2)
        return zp, hv, hf

    def gate(self, st: State, z, mask):
        """Gated nearest-neighbour scores against every active slot:
        (nis (NZ, n), nd (NZ, n)); nd = nis + log|S_j|."""
        n = st.n_active
        nz = z.shape[0]
        if n == 0:
            empty = torch.zeros((nz, 0), dtype=self.dtype, device=self.device)
            return empty, empty
        x, p = st.x, st.p
        zp, hv, hf = self.observe(x[:3], x[3:3 + 2 * n].view(n, 2))
        rows = 3 + 2 * torch.arange(n, device=self.device)[:, None] + torch.arange(2, device=self.device)
        pvm = p[:3, 3:3 + 2 * n].reshape(3, n, 2).permute(1, 0, 2)       # (n, 3, 2)
        pjj = p[rows[:, :, None], rows[:, None, :]]                       # (n, 2, 2)
        cross = self.mm(self.mm(hv, pvm), hf.transpose(1, 2))
        s = (self.mm(self.mm(hv, p[:3, :3].expand(n, 3, 3)), hv.transpose(1, 2))
             + cross + cross.transpose(1, 2)
             + self.mm(self.mm(hf, pjj), hf.transpose(1, 2)) + self.re)
        sinv = torch.linalg.inv(s)
        logdet = torch.logdet(s)
        v = z[:, None, :] - zp[None, :, :]
        v = torch.stack([v[..., 0], wrap(v[..., 1])], -1)                 # (NZ, n, 2)
        nis = torch.einsum("ina,nab,inb->in", v, sinv, v)
        return nis, nis + logdet[None, :]

    def update(self, st: State, z, pairs):
        """One batch update over ``pairs`` [(measurement, slot)]."""
        if not pairs:
            return
        x, p = st.x, st.p
        d = x.shape[0]
        meas = torch.tensor([i for i, _ in pairs], device=self.device)
        slots = torch.tensor([j for _, j in pairs], device=self.device)
        m = len(pairs)
        feats = x[3:3 + 2 * st.capacity].view(-1, 2)[slots]
        zp, hv, hf = self.observe(x[:3], feats)
        h = torch.zeros((m, 2, d), dtype=self.dtype, device=self.device)
        h[:, :, :3] = hv
        cols = 3 + 2 * slots[:, None] + torch.arange(2, device=self.device)
        h.scatter_(2, cols[:, None, :].expand(m, 2, 2), hf)
        h = h.reshape(2 * m, d)
        dz = z[meas] - zp
        v = torch.stack([dz[:, 0], wrap(dz[:, 1])], -1).reshape(2 * m, 1)
        r = torch.block_diag(*([self.re] * m))
        pht = self.mm(p, h.T)                                             # (D, 2m)
        s = self.mm(h, pht) + r
        chol = torch.linalg.cholesky(0.5 * (s + s.T))
        wt = torch.linalg.solve_triangular(chol, pht.T, upper=False)      # (2m, D)
        lv = torch.linalg.solve_triangular(chol, v, upper=False)
        x += self.mm(wt.T, lv)[:, 0]
        x[2] = wrap(x[2])
        self.sub_outer(p, wt.T)

    def augment(self, st: State, z, ids, new):
        """A new map slot for each of ``new`` (measurement indices, in
        buffer order) while capacity lasts, from the post-update pose."""
        x, p = st.x, st.p
        for i in new:
            s = st.n_active
            if s >= st.capacity:
                return
            rng, brg = z[i, 0], z[i, 1]
            ang = x[2] + brg
            sn, cs = torch.sin(ang), torch.cos(ang)
            one, zero = torch.ones_like(rng), torch.zeros_like(rng)
            gv = torch.stack([torch.stack([one, zero, -rng * sn]),
                              torch.stack([zero, one, rng * cs])])
            gz = torch.stack([torch.stack([cs, -rng * sn]), torch.stack([sn, rng * cs])])
            a, b = 3 + 2 * s, 5 + 2 * s
            x[a:b] = torch.stack([x[0] + rng * cs, x[1] + rng * sn])
            strip = self.mm(gv, p[:3, :])
            p[a:b, :] = strip
            p[:, a:b] = strip.T
            p[a:b, a:b] = (self.mm(self.mm(gv, p[:3, :3]), gv.T)
                           + self.mm(self.mm(gz, self.re), gz.T))
            st.table[int(ids[i])] = s
            st.n_active = s + 1

    # --------------------------------------------------------------- frame

    def decisions(self, nis, nd, mask_live, g_rej, g_aug):
        """Per measurement: ("known", slot), ("new",) or ("skip",)."""
        out = []
        for i, ok in enumerate(mask_live):
            if not ok:
                out.append(("skip",))
                continue
            if nis.shape[1] == 0:
                out.append(("new",) if math.inf > g_aug else ("skip",))
                continue
            gated = nis[i] < g_rej
            if bool(gated.any()):
                out.append(("known", int(torch.argmin(torch.where(gated, nd[i], math.inf)))))
            elif float(nis[i].min()) > g_aug:
                out.append(("new",))
            else:
                out.append(("skip",))
        return out

    def alternatives(self, nis, nd, mask_live, base, rel: float):
        """The measurements whose decision a relative change ``rel`` of the
        gates or of the scores' order would flip, each with its other
        decisions: {measurement: [decisions other than ``base``'s]}."""
        c = self.c
        alts: dict[int, set] = {}
        for gr, ga in itertools.product((1 - rel, 1 + rel), repeat=2):
            for i, dec in enumerate(self.decisions(nis, nd, mask_live, c["gate_reject"] * gr,
                                                   c["gate_augment"] * ga)):
                if dec != base[i]:
                    alts.setdefault(i, set()).add(dec)
        if nis.shape[1] > 1:
            gated = nis < c["gate_reject"] * (1 + rel)
            ndm = torch.where(gated, nd, math.inf)
            two = torch.topk(ndm, 2, dim=1, largest=False)
            near = (two.values[:, 1] - two.values[:, 0]) <= rel * (1.0 + two.values[:, 0].abs())
            for i in torch.nonzero(near).flatten().tolist():
                if mask_live[i] and base[i][0] == "known":
                    other = int(two.indices[i, 1]) if int(two.indices[i, 0]) == base[i][1] \
                        else int(two.indices[i, 0])
                    alts.setdefault(i, set()).add(("known", other))
        return {i: sorted(a) for i, a in alts.items()}

    def frame(self, st: State, fr: Frame, choose=None):
        """One frame in place on ``st``.  Returns (pose after each step
        (S, 3), the measurements the frame mapped, the ambiguous decisions
        it met).  ``choose(st, resolve)`` picks among the frame's ambiguous
        decisions on the gated path (below); without it the reference's
        own decisions stand."""
        c = self.c
        self.device = st.x.device
        self.qe, self.re = self.noise_covs()
        s_steps = fr.swa.shape[0]
        vn = c["velocity"] + fr.ctrl_noise[:, 0].to(self.dtype) * c["sigma_v"] \
            if c["switch_control_noise"] else torch.full((s_steps,), c["velocity"], dtype=self.dtype,
                                                         device=self.device)
        swa = fr.swa.to(self.dtype)
        if c["switch_control_noise"]:
            swa = swa + fr.ctrl_noise[:, 1].to(self.dtype) * c["sigma_swa"]
        z = fr.z_true.to(self.dtype)
        if c["switch_sensor_noise"]:
            z = z + fr.obs_noise.to(self.dtype) * self.t([c["sigma_r"], c["sigma_b"]])
        mask = fr.mask.tolist()
        poses = []
        for k in range(s_steps):
            if fr.active[k]:
                self.predict(st, vn[k], swa[k])
                if c["switch_heading_known"]:
                    self.observe_heading(st, fr.x_true[k, 2].to(self.dtype))
            poses.append(st.x[:3].clone())
        live = [m and not fr.done for m in mask]
        self.last_min_nis = None
        if c["switch_association_known"]:
            slots = st.table[fr.ids.clamp(min=0)].tolist()
            base = [("known", j) if ok and j >= 0 else ("new",) if ok else ("skip",)
                    for ok, j in zip(live, slots)]
            alts = {}
        else:
            nis, nd = self.gate(st, z, fr.mask)
            self.last_min_nis = nis.min(1).values if nis.shape[1] else None
            base = self.decisions(nis, nd, live, c["gate_reject"], c["gate_augment"])
            alts = self.alternatives(nis, nd, live, base, c["tie_rel"]) if choose else {}

        def finish(target: State, dec):
            self.update(target, z, [(i, d[1]) for i, d in enumerate(dec) if d[0] == "known"])
            new = [i for i, d in enumerate(dec) if d[0] == "new"]
            if c["enable_augment"]:
                before = target.n_active
                self.augment(target, z, fr.ids, new)
                return [int(fr.ids[i]) for i in new][: target.n_active - before]
            return []

        if not alts:
            mapped = finish(st, base)
        else:
            def resolve(dec_override):
                trial = State(st.x.clone(), st.p.clone(), st.n_active, st.table.clone())
                dec = list(base)
                for i, d in dec_override.items():
                    dec[i] = d
                return trial, finish(trial, dec)
            chosen, mapped = choose(alts, resolve)
            st.x, st.p, st.n_active, st.table = chosen.x, chosen.p, chosen.n_active, chosen.table
        poses[-1] = st.x[:3].clone()
        return torch.stack(poses), mapped, len(alts)
