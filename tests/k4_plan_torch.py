"""A plain emulation of K4's planned body (csrc/bilinear.cu,
planned_adjoint_kernel) on the plan of ops/bilinear_cuda.build_adjoint_plan:
tile by tile, each tile's bands in groups of GROUP_BANDS expanded into row
segments, the group's queries staged CHUNK at a time, each staged query's
tap kept where it lies in the tile's 33 x 33 window of tap cells, and each
pixel's sum taken over its four cells in the kernel's order (the cells
row-major: the weights w3, w2, w1, then w0 of its own tap's cell; each
cell's queries in staging order), for the tests of the plan and of the
traversal."""

import torch

from pyimcom_tpu_torch.ops.bilinear_cuda import PLAN_BAND as BAND
from pyimcom_tpu_torch.ops.bilinear_cuda import PLAN_CHUNK as CHUNK
from pyimcom_tpu_torch.ops.bilinear_cuda import PLAN_TILE as TILE

GROUP_BANDS = 16                       # csrc/bilinear.cu: kGroupBands


def unpack(span):
    """(lo, hi) of a packed band span (lo > hi: no query)."""
    s = int(span) & 0xFFFFFFFF
    return s & 0xFFFF, s >> 16


def group_queries(plan, t, group):
    """The flat query indices of band group `group` of tile `t`, in the
    kernel's staging order (band, row, column)."""
    qny, qnx = plan.grid
    row_lo, row_hi = (int(v) for v in plan.rows[t])
    p0, p1 = int(plan.ptr[t]), int(plan.ptr[t + 1])
    out = []
    for k in range(group * GROUP_BANDS, min(p1 - p0, (group + 1) * GROUP_BANDS)):
        lo, hi = unpack(plan.spans[p0 + k])
        for r in range(row_lo + BAND * k, min(row_lo + BAND * k + BAND - 1, row_hi) + 1):
            out.extend(range(r * qnx + lo, r * qnx + hi + 1))
    return torch.tensor(out, dtype=torch.int64)


def tile_windows(plan, t):
    """Every query index the kernel stages for tile `t` (with repeats where
    a query is staged twice, which a right plan never does)."""
    nb = int(plan.ptr[t + 1] - plan.ptr[t])
    groups = max(1, -(-nb // GROUP_BANDS))
    return torch.cat([group_queries(plan, t, g) for g in range(groups)])


def planned_adjoint(values, xf, yf, shape, plan, g_eff=None, out=None, chunk=CHUNK):
    """K4's planned traversal in float64 on the CPU: the (ny, nx) adjoint,
    or `out` with it added (a tile without a band leaves `out` as it is)."""
    ny, nx = shape
    tiles_x = -(-nx // TILE)
    T = -(-ny // TILE) * tiles_x
    v_all = values.reshape(-1).double()
    x_all = xf.reshape(-1).double()
    y_all = yf.reshape(-1).double()
    g = None if g_eff is None else g_eff.double()
    res = torch.zeros((ny, nx), dtype=torch.float64) if out is None else out
    for t in range(T):
        r0, c0 = (t // tiles_x) * TILE, (t % tiles_x) * TILE
        wy, wx = r0 - 1, c0 - 1
        acc = torch.zeros(TILE * TILE, dtype=torch.float64)
        nb = int(plan.ptr[t + 1] - plan.ptr[t])
        for group in range(max(1, -(-nb // GROUP_BANDS))):
            q_all = group_queries(plan, t, group)
            for e0 in range(0, len(q_all), chunk):
                q = q_all[e0:e0 + chunk]
                x, y, v = x_all[q], y_all[q], v_all[q]
                fx0, fy0 = torch.floor(x), torch.floor(y)
                inb = (fx0 >= 0) & (fx0 < nx - 1) & (fy0 >= 0) & (fy0 < ny - 1)
                ix = torch.where(inb, fx0, 0.0).long()
                iy = torch.where(inb, fy0, 0.0).long()
                cy, cx = iy - wy, ix - wx
                keep = inb & (cy >= 0) & (cy <= TILE) & (cx >= 0) & (cx <= TILE)
                idx = torch.nonzero(keep).reshape(-1)          # staging order
                x, y, v = x[idx], y[idx], v[idx]
                ix, iy, cy, cx = ix[idx], iy[idx], cy[idx], cx[idx]
                fx, fy = x - ix, y - iy
                w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy])
                if g is not None:
                    gt = torch.stack([g[iy, ix], g[iy, ix + 1], g[iy + 1, ix],
                                      g[iy + 1, ix + 1]])
                    norm = (w * gt).sum(0)
                    v = v / torch.where(norm > 0, norm, 1.0)
                # pixel (py, px) of the tile takes weight k of the queries of
                # cell (py + (k < 2), px + (k even)): k 3 first, each cell's
                # queries in staging order
                pix, prod, key = [], [], []
                for k, (dy, dx) in enumerate(((1, 1), (1, 0), (0, 1), (0, 0))):
                    py, px = cy - dy, cx - dx
                    on = (py >= 0) & (py < TILE) & (px >= 0) & (px < TILE)
                    wk = w[k] if g is None else w[k] * g[r0 + py.clamp(0, TILE - 1),
                                                         c0 + px.clamp(0, TILE - 1)]
                    pix.append((py * TILE + px)[on])
                    prod.append((v * wk)[on])
                    key.append(torch.full_like(pix[-1], 3 - k) * len(q)
                               + torch.nonzero(on)[:, 0])
                pix, prod, key = torch.cat(pix), torch.cat(prod), torch.cat(key)
                order = torch.argsort(pix * (4 * len(q) + 1) + key)
                acc.index_add_(0, pix[order], prod[order])
        acc = acc.reshape(TILE, TILE)[:min(TILE, ny - r0), :min(TILE, nx - c0)]
        if out is None:
            res[r0:r0 + TILE, c0:c0 + TILE] = acc
        elif nb:
            res[r0:r0 + TILE, c0:c0 + TILE] += acc
    return res
