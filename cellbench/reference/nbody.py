"""Plain PyTorch reference of ``nbody`` and the comparison that decides
``correct``.

All-pairs gravity with Plummer softening: a_i = sum_j m_j (r_j - r_i)
(|r_j - r_i|^2 + eps^2)^(-3/2), then v += a dt and p += v dt, a step at
a time. The pairwise terms are made ``chunk`` i-rows at a time, so no
(n, n) temporary is held. Imports nothing of the program.
"""

import torch

CHUNK = 4096  # i-rows a block: (4096, 65 536) float32 temporaries, 1 GiB


def _forces(px, py, pz, m, eps2, chunk):
    ax, ay, az = (torch.empty_like(px) for _ in range(3))
    for i0 in range(0, px.numel(), chunk):
        i = slice(i0, i0 + chunk)
        dx = px[None, :] - px[i, None]
        dy = py[None, :] - py[i, None]
        dz = pz[None, :] - pz[i, None]
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + eps2)
        w = m[None, :] * (inv * inv * inv)
        ax[i] = (w * dx).sum(dim=1)
        ay[i] = (w * dy).sum(dim=1)
        az[i] = (w * dz).sum(dim=1)
    return ax, ay, az


def reference(operands, statics: dict, dtype=torch.float32,
              chunk: int = CHUNK):
    """``(px, py, pz, vx, vy, vz)`` after ``statics["steps"]`` steps,
    computed in ``dtype`` (the configuration's float32; a lower one for
    the control). eps^2 is squared in double and rounded to float32, as
    the C driver passes it."""
    px, py, pz, vx, vy, vz, m = (a.to(dtype) for a in operands)
    dt = float(statics["dt"])
    eps = float(statics["eps"])
    eps2 = float(torch.tensor(eps * eps, dtype=torch.float32))
    for _ in range(int(statics["steps"])):
        ax, ay, az = _forces(px, py, pz, m, eps2, chunk)
        vx = vx + ax * dt
        vy = vy + ay * dt
        vz = vz + az * dt
        px = px + vx * dt
        py = py + vy * dt
        pz = pz + vz * dt
    return (px, py, pz, vx, vy, vz)


def _widest(got, want, start) -> float:
    """The largest |got - want| over the three components, over the
    largest |want - start|: the error against the largest change."""
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    moved = max(float((w.double() - s.double()).abs().max())
                for w, s in zip(want, start))
    return err / moved if moved > 0 else float("inf")


def compare(got, want, operands, statics: dict) -> dict:
    """``pos_err`` and ``vel_err``: the widest gap of the positions and
    of the velocities, each against the largest change the reference
    made to them."""
    if len(got) != 6 or any(g.shape != w.shape for g, w in zip(got, want)):
        return {"pos_err": float("inf"), "vel_err": float("inf")}
    return {"pos_err": _widest(got[:3], want[:3], operands[:3]),
            "vel_err": _widest(got[3:], want[3:], operands[3:6])}
