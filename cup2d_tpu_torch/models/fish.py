"""Self-propelled fish swimmer: midline kinematics on the host.

The port's own copy of ``cup2d_tpu.models.fish`` (numpy only; the port
imports nothing of the JAX package). The reference's Shape/ongrid
machinery (main.cpp:3548-3710 schedulers, 111-161 if2d_solve, 3991-4207
the kinematics part of ongrid, 6413-6443 discretization and width
profile): the midline is O(10^2) nodes of sequential, branchy f64 work
recomputed once per step on the host. Everything per cell (SDF
rasterization, chi, integrals, penalization) runs on the device from the
arrays this module produces (``cup2d_tpu_torch/ops/obstacle.py``).

All host math is numpy float64, like the reference's Real=double; the
state it leaves after any sequence of ``advect``/``midline`` calls is bit
for bit the JAX package's.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Interpolation primitives (reference IF2D_Interpolation1D, main.cpp:3476-3547)
# ---------------------------------------------------------------------------

def natural_cubic_spline(x, y, xx):
    """Natural cubic spline through (x, y) evaluated at xx
    (main.cpp:3477-3523). x strictly increasing."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    y2 = np.zeros(n)
    u = np.zeros(n - 1)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        u[i] = (y[i + 1] - y[i]) / (x[i + 1] - x[i]) - (y[i] - y[i - 1]) / (
            x[i] - x[i - 1]
        )
        u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    y2[n - 1] = 0.0
    for k in range(n - 2, 0, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    y2[0] = 0.0

    xx = np.asarray(xx, dtype=np.float64)
    klo = np.clip(np.searchsorted(x, xx, side="right") - 1, 0, n - 2)
    khi = klo + 1
    h = x[khi] - x[klo]
    a = (x[khi] - xx) / h
    b = (xx - x[klo]) / h
    return (
        a * y[klo] + b * y[khi]
        + ((a**3 - a) * y2[klo] + (b**3 - b) * y2[khi]) * (h * h) / 6.0
    )


def cubic_interp(x0, x1, x, y0, y1, dy0=0.0, dy1=0.0):
    """Hermite cubic between (x0,y0,dy0) and (x1,y1,dy1); returns (y, dy)
    (main.cpp:3524-3539). Vectorized over y0/y1/dy0."""
    xrel = x - x0
    dx = x1 - x0
    a = (dy0 + dy1) / (dx * dx) - 2.0 * (y1 - y0) / (dx * dx * dx)
    b = (-2.0 * dy0 - dy1) / dx + 3.0 * (y1 - y0) / (dx * dx)
    c = dy0
    d = y0
    y = a * xrel**3 + b * xrel**2 + c * xrel + d
    dy = 3.0 * a * xrel**2 + 2.0 * b * xrel + c
    return y, dy


# ---------------------------------------------------------------------------
# Schedulers (main.cpp:3548-3710)
# ---------------------------------------------------------------------------

class SchedulerScalar:
    """Cubic-in-time transition of one scalar (SchedulerScalar,
    main.cpp:3608-3622)."""

    def __init__(self):
        self.t0, self.t1 = -1.0, 0.0
        self.p0, self.p1 = 0.0, 0.0
        self.dp0 = 0.0

    def transition(self, t, tstart, tend, pstart, pend):
        if t < tstart or t > tend:
            return
        if tstart < self.t0:
            return
        self.t0, self.t1 = tstart, tend
        self.p0, self.p1 = pstart, pend

    def gimme(self, t):
        if t < self.t0 or self.t0 < 0:
            return self.p0, 0.0
        if t > self.t1:
            return self.p1, 0.0
        return cubic_interp(self.t0, self.t1, t, self.p0, self.p1, self.dp0, 0.0)


class SchedulerVector:
    """N control values cubic in time, natural-spline in arclength
    (SchedulerVector, main.cpp:3623-3662)."""

    def __init__(self, npoints):
        self.n = npoints
        self.t0, self.t1 = -1.0, 0.0
        self.p0 = np.zeros(npoints)
        self.p1 = np.zeros(npoints)
        self.dp0 = np.zeros(npoints)

    def transition(self, t, tstart, tend, pstart, pend):
        if t < tstart or t > tend:
            return
        if tstart < self.t0:
            return
        self.t0, self.t1 = tstart, tend
        self.p0 = np.asarray(pstart, dtype=np.float64).copy()
        self.p1 = np.asarray(pend, dtype=np.float64).copy()

    def gimme_fine(self, t, positions, positions_fine):
        """Returns (parameters_fine, dparameters_fine) at positions_fine."""
        p0f = natural_cubic_spline(positions, self.p0, positions_fine)
        p1f = natural_cubic_spline(positions, self.p1, positions_fine)
        dp0f = natural_cubic_spline(positions, self.dp0, positions_fine)
        if t < self.t0 or self.t0 < 0:
            return p0f, np.zeros_like(p0f)
        if t > self.t1:
            return p1f, np.zeros_like(p1f)
        return cubic_interp(self.t0, self.t1, t, p0f, p1f, dp0f, 0.0)


class SchedulerLearnWave:
    """Traveling-wave interpolation of RL bending actions
    (SchedulerLearnWave, main.cpp:3663-3710): control point j holds the
    j-th most recent action; the wave coordinate c = s/L - (t-t0)/Twave
    rides tailward so each action propagates head->tail."""

    def __init__(self, npoints):
        self.n = npoints
        self.t0 = -1.0
        self.p0 = np.zeros(npoints)

    def turn(self, b, t_turn):
        """Inject action b (main.cpp:3703-3710)."""
        self.t0 = t_turn
        self.p0[2:] = self.p0[:-2].copy()[: self.n - 2]
        self.p0[1] = b
        self.p0[0] = 0.0

    def gimme_fine(self, t, twave, length, positions, positions_fine):
        c = positions_fine / length - (t - self.t0) / twave
        params = np.zeros_like(positions_fine)
        dparams = np.zeros_like(positions_fine)
        below = c < positions[0]
        above = c > positions[-1]
        params[below] = self.p0[0]
        params[above] = self.p0[-1]
        mid = ~(below | above)
        if np.any(mid):
            cm = c[mid]
            j = np.clip(np.searchsorted(positions, cm, side="left"), 1,
                        self.n - 1)
            y, dy = cubic_interp(
                positions[j - 1], positions[j], cm,
                self.p0[j - 1], self.p0[j],
            )
            params[mid] = y
            dparams[mid] = -dy / twave
        return params, dparams


# ---------------------------------------------------------------------------
# Frenet midline integration (if2d_solve, main.cpp:111-161)
# ---------------------------------------------------------------------------

def if2d_solve(rS, curv, curv_dt):
    """Integrate curvature -> midline positions/velocities/normals.
    Sequential O(Nm) recurrence, numpy scalars (the reference's exact
    update order incl. per-step renormalization of ksi and nor)."""
    nm = len(rS)
    rX = np.zeros(nm); rY = np.zeros(nm)
    vX = np.zeros(nm); vY = np.zeros(nm)
    norX = np.zeros(nm); norY = np.zeros(nm)
    vNorX = np.zeros(nm); vNorY = np.zeros(nm)
    norY[0] = 1.0
    ksiX, ksiY = 1.0, 0.0
    vKsiX, vKsiY = 0.0, 0.0
    eps = np.finfo(np.float64).eps
    for i in range(1, nm):
        dksiX = curv[i - 1] * norX[i - 1]
        dksiY = curv[i - 1] * norY[i - 1]
        dnuX = -curv[i - 1] * ksiX
        dnuY = -curv[i - 1] * ksiY
        dvKsiX = curv_dt[i - 1] * norX[i - 1] + curv[i - 1] * vNorX[i - 1]
        dvKsiY = curv_dt[i - 1] * norY[i - 1] + curv[i - 1] * vNorY[i - 1]
        dvNuX = -curv_dt[i - 1] * ksiX - curv[i - 1] * vKsiX
        dvNuY = -curv_dt[i - 1] * ksiY - curv[i - 1] * vKsiY
        ds = rS[i] - rS[i - 1]
        rX[i] = rX[i - 1] + ds * ksiX
        rY[i] = rY[i - 1] + ds * ksiY
        norX[i] = norX[i - 1] + ds * dnuX
        norY[i] = norY[i - 1] + ds * dnuY
        ksiX += ds * dksiX
        ksiY += ds * dksiY
        vX[i] = vX[i - 1] + ds * vKsiX
        vY[i] = vY[i - 1] + ds * vKsiY
        vNorX[i] = vNorX[i - 1] + ds * dvNuX
        vNorY[i] = vNorY[i - 1] + ds * dvNuY
        vKsiX += ds * dvKsiX
        vKsiY += ds * dvKsiY
        d1 = ksiX * ksiX + ksiY * ksiY
        d2 = norX[i] * norX[i] + norY[i] * norY[i]
        if d1 > eps:
            f = 1.0 / np.sqrt(d1)
            ksiX *= f
            ksiY *= f
        if d2 > eps:
            f = 1.0 / np.sqrt(d2)
            norX[i] *= f
            norY[i] *= f
    return rX, rY, vX, vY, norX, norY, vNorX, vNorY


def _dds(a, b):
    """Centered d(a)/d(b) with one-sided ends (reference dds,
    main.cpp:36-45), vectorized. Zero-length intervals (coarse grids can
    produce dSref == 0 in the end-refinement ramp, where width == 0 and
    the contribution vanishes anyway) contribute 0 instead of inf."""
    out = np.empty_like(a)
    db = np.diff(b)
    fwd = np.divide(np.diff(a), db, out=np.zeros_like(db), where=db > 0)
    out[0] = fwd[0]
    out[-1] = fwd[-1]
    out[1:-1] = 0.5 * (fwd[1:] + fwd[:-1])
    return out


def _rot(ang, x, y):
    c, s = np.cos(ang), np.sin(ang)
    return c * x - s * y, s * x + c * y


class FishShape:
    """One self-propelled swimmer: geometry, schedulers, rigid + internal
    state, and the per-step midline pipeline (reference Shape +
    ongrid kinematics, main.cpp:3711-3773, 3991-4207, 6386-6446)."""

    def __init__(self, length, xpos, ypos, angle_deg, min_h,
                 phase_shift=0.0, period=1.0):
        self.length = float(length)
        self.center = np.array([xpos, ypos], dtype=np.float64)
        self.com = np.array([xpos, ypos], dtype=np.float64)
        self.orientation = float(angle_deg) * np.pi / 180.0
        self.u = 0.0
        self.v = 0.0
        self.omega = 0.0
        self.d_gm = np.zeros(2)
        self.phase_shift = float(phase_shift)
        self.theta_internal = 0.0
        self.angvel_internal = 0.0
        self.time0 = 0.0
        self.timeshift = 0.0
        self.current_period = float(period)
        self.next_period = float(period)
        self.transition_start = 0.0
        self.transition_duration = 0.1
        self.period_val = float(period)
        self.period_dif = 0.0
        self.M = 0.0
        self.J = 0.0
        self.area = 0.0
        self.free = True   # fish always move under the momentum solve

        # --- midline discretization (main.cpp:3733-3741, 6413-6425) ---
        L = self.length
        frac_refined = 0.1
        frac_mid = 1.0 - 2.0 * frac_refined
        nmid = int(np.ceil(L * frac_mid / (min_h / np.sqrt(2.0)) / 8.0)) * 8
        ds_mid = L * frac_mid / nmid
        nend = int(np.ceil(frac_refined * L * 2.0
                           / (ds_mid + 0.125 * min_h) / 4.0)) * 4
        ds_ref = frac_refined * L * 2.0 / nend - ds_mid
        if ds_ref < 0.0:
            # the reference formula (main.cpp:3736-3740) goes negative when
            # min_h is coarse relative to L (ceil overshoot) and rS would
            # run backwards; shrink Nend so the end-ramp still sums to
            # fracRefined*L with non-negative spacing — at the reference's
            # resolutions this branch never fires
            nend = max(4, int(frac_refined * L * 2.0 / ds_mid / 4.0) * 4)
            ds_ref = max(frac_refined * L * 2.0 / nend - ds_mid, 0.0)
        self.nm = nmid + 2 * nend + 1
        rs = np.zeros(self.nm)
        k = 0
        for i in range(nend):
            rs[k + 1] = rs[k] + ds_ref + (ds_mid - ds_ref) * i / (nend - 1.0)
            k += 1
        for _ in range(nmid):
            rs[k + 1] = rs[k] + ds_mid
            k += 1
        for i in range(nend):
            rs[k + 1] = rs[k] + ds_ref + (ds_mid - ds_ref) * (
                nend - i - 1) / (nend - 1.0)
            k += 1
        rs[k] = min(rs[k], L)
        self.rS = rs

        # --- width profile (main.cpp:6429-6443) ---
        sb, st = 0.04 * L, 0.95 * L
        wt, wh = 0.01 * L, 0.04 * L
        s = self.rS
        w = np.where(
            s < sb, np.sqrt(np.maximum(2.0 * wh * s - s * s, 0.0)),
            np.where(
                s < st, wh - (wh - wt) * (s - sb) / (st - sb),
                wt * (L - s) / (L - st),
            ),
        )
        self.width = np.where((s < 0) | (s > L), 0.0, w)

        self.curvature_scheduler = SchedulerVector(6)
        self.rl_bending_scheduler = SchedulerLearnWave(7)
        self.period_scheduler = SchedulerScalar()
        # seed so a first midline() call at t > transition end still sees
        # the configured period (the reference always starts at t=0 inside
        # the window, main.cpp:4030-4034; entering later would divide by 0)
        self.period_scheduler.p0 = float(period)
        self.period_scheduler.p1 = float(period)

        # outputs of the last midline() call (fish frame, internal
        # momentum removed), used by rasterization and diagnostics
        self.rX = np.zeros(self.nm)
        self.rY = np.zeros(self.nm)
        self.vX = np.zeros(self.nm)
        self.vY = np.zeros(self.nm)
        self.norX = np.zeros(self.nm)
        self.norY = np.zeros(self.nm)
        self.vNorX = np.zeros(self.nm)
        self.vNorY = np.zeros(self.nm)
        self.skin_upper = np.zeros((self.nm, 2))
        self.skin_lower = np.zeros((self.nm, 2))

    # -- rigid advection (ongrid head, main.cpp:3992-4018) --
    def advect(self, dt, extents):
        self.com[0] += dt * self.u
        self.com[1] += dt * self.v
        self.orientation += dt * self.omega
        if self.orientation > np.pi:
            self.orientation -= 2.0 * np.pi
        if self.orientation < -np.pi:
            self.orientation += 2.0 * np.pi
        c, s = np.cos(self.orientation), np.sin(self.orientation)
        self.center[0] = self.com[0] + c * self.d_gm[0] - s * self.d_gm[1]
        self.center[1] = self.com[1] + s * self.d_gm[0] + c * self.d_gm[1]
        self.theta_internal -= dt * self.angvel_internal
        if not (0 < self.center[0] < extents[0]
                and 0 < self.center[1] < extents[1]):
            raise RuntimeError("a body out of the domain")

    # -- per-step midline pipeline (main.cpp:4029-4207) --
    def midline(self, time):
        L = self.length
        nm = self.nm
        self.period_scheduler.transition(
            time, self.transition_start,
            self.transition_start + self.transition_duration,
            self.current_period, self.next_period,
        )
        self.period_val, self.period_dif = self.period_scheduler.gimme(time)
        if (self.transition_start < time
                < self.transition_start + self.transition_duration):
            self.timeshift = (time - self.time0) / self.period_val \
                + self.timeshift
            self.time0 = time

        curv_points = np.array([0.0, 0.15, 0.4, 0.65, 0.9, 1.0]) * L
        curv_values = np.array(
            [0.82014, 1.46515, 2.57136, 3.75425, 5.09147, 5.70449]) / L
        bend_points = np.array([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0])
        self.curvature_scheduler.transition(
            0.0, 0.0, 1.0, 0.01 * curv_values, curv_values)
        rC, vC = self.curvature_scheduler.gimme_fine(
            time, curv_points, self.rS)
        rB, vB = self.rl_bending_scheduler.gimme_fine(
            time, self.period_val, L, bend_points, self.rS)

        diffT = 1.0 - (time - self.time0) * self.period_dif / self.period_val
        darg = 2.0 * np.pi / self.period_val * diffT
        arg0 = (2.0 * np.pi * ((time - self.time0) / self.period_val
                               + self.timeshift)
                + np.pi * self.phase_shift)
        arg = arg0 - 2.0 * np.pi * self.rS / L
        rK = rC * (np.sin(arg) + rB)
        vK = vC * (np.sin(arg) + rB) + rC * (np.cos(arg) * darg + vB)

        rX, rY, vX, vY, norX, norY, vNorX, vNorY = if2d_solve(
            self.rS, rK, vK)

        # skins from the integrated (normalized) normals (main.cpp:4086-4097)
        nmag = np.sqrt(norX**2 + norY**2)
        skin_u = np.stack([rX + self.width * norX / nmag,
                           rY + self.width * norY / nmag], axis=1)
        skin_l = np.stack([rX - self.width * norX / nmag,
                           rY - self.width * norY / nmag], axis=1)

        # area / CoM / linear momentum integrals with the width^3
        # curvature correction (main.cpp:4098-4130)
        ds = np.empty(nm)
        ds[0] = self.rS[1] - self.rS[0]
        ds[-1] = self.rS[-1] - self.rS[-2]
        ds[1:-1] = self.rS[2:] - self.rS[:-2]
        fac1 = 2.0 * self.width
        fac2 = (2.0 * self.width**3
                * (_dds(norX, self.rS) * norY - _dds(norY, self.rS) * norX)
                / 3.0)
        area = np.sum(fac1 * ds / 2.0)
        cmx = np.sum((rX * fac1 + norX * fac2) * ds / 2.0) / area
        cmy = np.sum((rY * fac1 + norY * fac2) * ds / 2.0) / area
        lmx = np.sum((vX * fac1 + vNorX * fac2) * ds / 2.0) / area
        lmy = np.sum((vY * fac1 + vNorY * fac2) * ds / 2.0) / area
        self.area = area

        rX = rX - cmx; rY = rY - cmy
        vX = vX - lmx; vY = vY - lmy

        # angular momentum / inertia (main.cpp:4131-4170)
        fac3 = 2.0 * self.width**3 / 3.0
        tmp_m = ((rX * vY - rY * vX) * fac1
                 + (rX * vNorY - rY * vNorX + vY * norX - vX * norY) * fac2
                 + (norX * vNorY - norY * vNorX) * fac3)
        tmp_j = ((rX * rX + rY * rY) * fac1
                 + 2.0 * (rX * norX + rY * norY) * fac2 + fac3)
        ang_mom = np.sum(tmp_m * ds / 2.0)
        j_int = np.sum(tmp_j * ds / 2.0)
        self.angvel_internal = ang_mom / j_int

        # rotate into the internal-angle-free frame and remove the spin
        # (main.cpp:4171-4184)
        vX = vX + self.angvel_internal * rY
        vY = vY - self.angvel_internal * rX
        rX, rY = _rot(self.theta_internal, rX, rY)
        vX, vY = _rot(self.theta_internal, vX, vY)

        # recompute normals from midline tangents (main.cpp:4185-4203);
        # zero-length end intervals inherit the previous node's normal
        dsn = np.diff(self.rS)
        ok = dsn > 0
        inv = np.divide(1.0, dsn, out=np.zeros_like(dsn), where=ok)
        norX = np.empty(nm); norY = np.empty(nm)
        vNorX = np.empty(nm); vNorY = np.empty(nm)
        norX[:-1] = -np.diff(rY) * inv
        norY[:-1] = np.diff(rX) * inv
        vNorX[:-1] = -np.diff(vY) * inv
        vNorY[:-1] = np.diff(vX) * inv
        for arr in (norX, norY, vNorX, vNorY):
            for i in np.nonzero(~ok)[0]:
                arr[i] = arr[i - 1] if i > 0 else arr[i + 1]
        norX[-1] = norX[-2]; norY[-1] = norY[-2]
        vNorX[-1] = vNorX[-2]; vNorY[-1] = vNorY[-2]

        # skins follow the same de-meaning + rotation (main.cpp:4204-4217)
        for skin in (skin_u, skin_l):
            skin[:, 0] -= cmx
            skin[:, 1] -= cmy
            skin[:, 0], skin[:, 1] = _rot(
                self.theta_internal, skin[:, 0], skin[:, 1])

        self.rX, self.rY, self.vX, self.vY = rX, rY, vX, vY
        self.norX, self.norY, self.vNorX, self.vNorY = (
            norX, norY, vNorX, vNorY)
        self.skin_upper, self.skin_lower = skin_u, skin_l

    # -- computational-frame surface polygon for the SDF kernel --
    def surface_polygon(self):
        """Closed surface polyline in the computational frame: upper skin
        head->tail then lower skin tail->head (the same two offset curves
        the reference rasterizes per segment, main.cpp:4300-4310)."""
        pts = np.concatenate([self.skin_upper, self.skin_lower[::-1]], axis=0)
        x, y = _rot(self.orientation, pts[:, 0], pts[:, 1])
        return np.stack([x + self.center[0], y + self.center[1]], axis=1)

    def midline_comp_frame(self):
        """Midline nodes r, velocities v, normals n, normal-velocities vn
        rotated to the computational frame (velocities rotate without
        translation — changeVelocityToComputationalFrame,
        main.cpp:3975-3979)."""
        rx, ry = _rot(self.orientation, self.rX, self.rY)
        vx, vy = _rot(self.orientation, self.vX, self.vY)
        nx, ny = _rot(self.orientation, self.norX, self.norY)
        vnx, vny = _rot(self.orientation, self.vNorX, self.vNorY)
        return (np.stack([rx + self.center[0], ry + self.center[1]], axis=1),
                np.stack([vx, vy], axis=1),
                np.stack([nx, ny], axis=1),
                np.stack([vnx, vny], axis=1))
