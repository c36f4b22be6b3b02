"""Shape-shape collisions: chi-overlap detection and the e = 1 impulse
response, the counterpart of ``cup2d_tpu.ops.collision``.

The reference's collision pipeline (main.cpp:6705-6943 detection and
overlap integrals, 209-235 compute_j, 236-291 the elastic impulse solve),
specialized to 2-D, as plain PyTorch on the per-shape chi/sdf/udef fields.
Everything stays on the device: the pair loop selects each pair's update
with ``torch.where`` on its ``hit`` flag and reads nothing back to the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from .stencil import pad_scalar, shift

_EPS = 1e-21  # reference impulse denominator guard (main.cpp:282)


def _overlap_sums(w, sdf_i, udef_i, uvw_i, com_i, x, y, total=torch.sum):
    """The 7 chi-weighted overlap sums of one shape given its per-cell
    weight ``w`` (main.cpp:6733-6815): mass, position, momentum (rigid
    plus deformation) and the own-SDF gradient (the contact normal).
    Unweighted by h^2, as in the reference (its iM < 2 gate counts
    cells). Returns [7]."""
    ur_x = -uvw_i[2] * (y - com_i[1])
    ur_y = uvw_i[2] * (x - com_i[0])
    # central SDF gradient (undivided) on an edge-padded lab
    lab = pad_scalar(sdf_i, 1)
    gx = 0.5 * (shift(lab, 1, 0, 1) - shift(lab, 1, 0, -1))
    gy = 0.5 * (shift(lab, 1, 1, 0) - shift(lab, 1, -1, 0))
    return torch.stack([
        total(w),
        total(w * x),
        total(w * y),
        total(w * (uvw_i[0] + ur_x + udef_i[0])),
        total(w * (uvw_i[1] + ur_y + udef_i[1])),
        total(w * gx),
        total(w * gy),
    ])


def overlap_integrals(chi_i, chi_j, sdf_i, udef_i, uvw_i, com_i, x, y):
    """Shape i's overlap sums against one opponent j: the cells where both
    chi > 0, weighted by chi_i."""
    w = torch.where((chi_i > 0.0) & (chi_j > 0.0), chi_i, 0.0)
    return _overlap_sums(w, sdf_i, udef_i, uvw_i, com_i, x, y)


def merged_overlap_integrals(chi_s, sdf_s, udef_s, uvw, com, x, y,
                             total=torch.sum):
    """Every shape's opponent-merged overlap sums: shape i's cells
    weighted by chi_i times the number of opponents with chi_j > 0 there,
    which equals summing ``overlap_integrals`` over the opponents
    (main.cpp:6733-6815) in O(S N) field work. chi_s/sdf_s: [S, ...];
    udef_s: [S, 2, ...]; uvw: [S, 3]; com: [S, 2]. Returns [S, 7];
    ``total`` is the full sum of one shape's field (the forest passes
    ``shard_halo.block_sum``)."""
    cnt = torch.sum(chi_s > 0.0, dim=0)
    out = []
    for k in range(chi_s.shape[0]):
        chi_i = chi_s[k]
        others = (cnt - (chi_i > 0.0).to(cnt.dtype)).to(chi_i.dtype)
        w = torch.where(chi_i > 0.0, chi_i, 0.0) * others
        out.append(_overlap_sums(w, sdf_s[k], udef_s[k], uvw[k], com[k],
                                 x, y, total))
    return torch.stack(out)


def pairwise_collision_update(colls, uvw, mass, inertia, com, lengths):
    """Sequential e = 1 impulse updates over every (i < j) pair in the
    reference's pair order (main.cpp:6863-6943): earlier impulses feed
    later pairs through uvw. A pair that does not hit leaves uvw as it
    was (``torch.where``; no host read). Returns a new [S, 3]."""
    S = int(colls.shape[0])
    ii, jj = np.triu_indices(S, 1)
    for i, j in zip(ii.tolist(), jj.tolist()):
        new_i, new_j, _hit = collision_response(
            colls[i], colls[j], uvw[i], uvw[j], mass[i], mass[j],
            inertia[i], inertia[j], com[i], com[j], lengths[i])
        uvw = uvw.clone()
        uvw[i] = new_i
        uvw[j] = new_j
    return uvw


def collision_response(coll_i, coll_j, uvw_i, uvw_j, m1, m2, j1, j2,
                       com_i, com_j, length_i):
    """Impulse response of the pair (i, j) (main.cpp:6862-6943 and
    collision(), 236-291, e = 1). Returns (new_uvw_i, new_uvw_j, hit):
    too little overlap, separated centroids or a receding contact leave
    the inputs unchanged."""
    iM, iPx, iPy, iMx, iMy, ivx, ivy = coll_i
    jM, jPx, jPy, jMx, jMy, jvx, jvy = coll_j

    enough = (iM >= 2.0) & (jM >= 2.0)
    sep = (torch.abs(iPx / torch.clamp_min(iM, _EPS)
                     - jPx / torch.clamp_min(jM, _EPS)) > length_i) | (
        torch.abs(iPy / torch.clamp_min(iM, _EPS)
                  - jPy / torch.clamp_min(jM, _EPS)) > length_i)

    norm_i = torch.sqrt(ivx * ivx + ivy * ivy) + _EPS
    norm_j = torch.sqrt(jvx * jvx + jvy * jvy) + _EPS
    mx = ivx / norm_i - jvx / norm_j
    my = ivy / norm_i - jvy / norm_j
    inorm = 1.0 / (torch.sqrt(mx * mx + my * my) + _EPS)
    nx_ = mx * inorm
    ny_ = my * inorm

    iMs = torch.clamp_min(iM, _EPS)
    jMs = torch.clamp_min(jM, _EPS)
    vc1 = torch.stack([iMx / iMs, iMy / iMs])
    vc2 = torch.stack([jMx / jMs, jMy / jMs])
    proj_vel = (vc2[0] - vc1[0]) * nx_ + (vc2[1] - vc1[1]) * ny_

    cx = 0.5 * (iPx / iMs + jPx / jMs)
    cy = 0.5 * (iPy / iMs + jPy / jMs)

    # compute_j in 2-D: J = (r x N)_z / I (main.cpp:209-235 inverts the
    # diagonal [1, 1, I])
    r1x, r1y = cx - com_i[0], cy - com_i[1]
    r2x, r2y = cx - com_j[0], cy - com_j[1]
    jz1 = (r1x * ny_ - r1y * nx_) / torch.clamp_min(j1, _EPS)
    jz2 = -(r2x * ny_ - r2y * nx_) / torch.clamp_min(j2, _EPS)

    u1, v1, o1 = uvw_i[0], uvw_i[1], uvw_i[2]
    u2, v2, o2 = uvw_j[0], uvw_j[1], uvw_j[2]

    # u*DEF: the contact cloud's velocity less the rigid one at the contact
    u1d_x = vc1[0] - u1 + o1 * r1y
    u1d_y = vc1[1] - v1 - o1 * r1x
    u2d_x = vc2[0] - u2 + o2 * r2y
    u2d_y = vc2[1] - v2 - o2 * r2x

    e = 1.0
    nom = (e * ((vc1[0] - vc2[0]) * nx_ + (vc1[1] - vc2[1]) * ny_)
           + ((u1 - u2 + u1d_x - u2d_x) * nx_
              + (v1 - v2 + u1d_y - u2d_y) * ny_)
           + ((-o1 * r1y) * nx_ + (o1 * r1x) * ny_)
           - ((-o2 * r2y) * nx_ + (o2 * r2x) * ny_))
    denom = (-(1.0 / m1 + 1.0 / m2)
             + ((-jz1 * r1y) * (-nx_) + (jz1 * r1x) * (-ny_))
             - ((-jz2 * r2y) * (-nx_) + (jz2 * r2x) * (-ny_)))
    impulse = nom / (denom + _EPS)

    hit = enough & ~sep & (proj_vel > 0)
    new_i = torch.stack([
        u1 + nx_ / m1 * impulse,
        v1 + ny_ / m1 * impulse,
        o1 + jz1 * impulse,
    ])
    new_j = torch.stack([
        u2 - nx_ / m2 * impulse,
        v2 - ny_ / m2 * impulse,
        o2 + jz2 * impulse,
    ])
    return (torch.where(hit, new_i, uvw_i), torch.where(hit, new_j, uvw_j),
            hit)
