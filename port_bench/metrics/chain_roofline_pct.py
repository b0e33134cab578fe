"""chain_roofline_pct: the contact chain's least time on the card over
its mean device time per launch in the traced span, in percent.

The least time is the larger of bytes over HBM's published rate and
operations over the float32 peak outside the tensor cores (NVIDIA H100
SXM data sheet). Bytes, each input read once and each output written
once, for N rows, a (K, N) table, W fused walls and b bytes a value:

    N * (11 b + 1 + 4 K + 3 K b + 3 W b + 6 b) + 3 b * contacts

the row (pos, vel, omega 9 values, radius, mass, the active byte), the
index column, the slot history written (3K), the wall history written
(3W), force and torque (6); plus three values of history read for each
touching slot and each touching wall, counted from the state at the
span's end. Operations: FLOPS_PER_CONTACT per contact. A frozen copy of
the program's chip_smoke.chain_bound.
"""

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
FLOPS_PER_CONTACT = 150


def slots_within(p, periodic_len):
    """Table slots of state p whose partner touches its particle."""
    n = p.pos.shape[0]
    idx = p.nbr_idx.long()
    j = idx.clamp(0, n - 1)
    d = p.pos[None, :] - p.pos[j]
    for a, L in enumerate(periodic_len or ()):
        if L is not None:
            d[..., a] -= L * torch.round(d[..., a] / L)
    reach = p.radius[None, :] + p.radius[j]
    within = (idx >= 0) & (idx < n) & p.active[None, :] & \
        ((d * d).sum(-1) < reach * reach)
    return int(within.sum())


def fused_walls(walls):
    """The walls the kernel computes: static planes only, all or none."""
    fusible = all(w.style != "zcylinder" and not w.wiggle
                  and w.vshear == 0.0 for w in walls)
    return walls if fusible else ()


def bound_s(p, walls, periodic_len):
    """The least seconds of one contact_chain launch on state p."""
    n, K, W = p.pos.shape[0], p.nbr_idx.shape[0], len(walls)
    b = p.pos.element_size()
    wall_contacts = 0
    for w in walls:
        x = p.pos[:, w.axis]
        lo = w.lo if w.lo is not None else -1e30
        hi = w.hi if w.hi is not None else 1e30
        da = torch.where(x - lo < hi - x, x - lo, x - hi)
        wall_contacts += int((p.active & (da * da <= p.radius ** 2)
                              & (da * da > 0)).sum())
    contacts = slots_within(p, periodic_len) + wall_contacts
    nbytes = n * (11 * b + 1 + 4 * K + 3 * K * b + 3 * W * b + 6 * b) + \
        3 * b * contacts
    flops = FLOPS_PER_CONTACT * contacts
    peak = PEAK_FLOPS[str(p.pos.dtype).split(".")[-1]]
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def read(rec):
    times = [b - a for n, a, b in rec.get("ops", ()) if "chain_kernel" in n]
    if not times:
        return None
    dem = rec["cfg"].dem
    mean_s = sum(times) / len(times) / 1e6
    return 100.0 * bound_s(rec["particles"], fused_walls(dem.walls),
                           dem.periodic_len()) / mean_s
