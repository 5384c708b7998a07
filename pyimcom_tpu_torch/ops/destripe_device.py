"""
Device-resident destriping cost and gradient on PyTorch.

Counterpart of pyimcom_tpu/ops/destripe_device.py.  :class:`DestripeCost`
keeps every SCA image, gain map and mask on the device and writes the whole
cost -- stripe model, gain-weighted bilinear resampling of each neighbour
onto its target's grid, penalty model, amplifier boundary-continuity term --
as one differentiable PyTorch function; ``torch.autograd.grad`` gives its
exact gradient, through the gain weighting too.  The pair gather is
:class:`~.bilinear.BilinearGather` (kernel K3 on the card, its adjoint K4 in
the backward), added in place into the target's accumulator; its positions
and the accumulator keep the target's (ny, nx) pixel grid.  It saves no
per-pair output for the backward: the JAX package rematerialises its scan
for the same reason (P saved planes of 4088^2 would add P x 134 MB).  The
hit counts, the valid pixels and, on a CUDA device, K4's plan of each pair
(which queries add into each 32 x 32 tile of the target's grid; ~1 MB a
4088^2 pair, built by the plan kernel and kept on the device whatever the
maps' storage) depend on the maps alone, so they are computed once, when
the module is built, in the one walk over the pairs that counts the hits
(the plan kernel waits for nothing; one read-back at the end of the build
takes every plan's counts).  A pair whose plan overflowed (a map shrunk ~5x
or more: bilinear_cuda.plan_route) runs K4's off-plan body on every
gradient.  On the CPU the plain adjoint runs, which takes no plan.

The pair maps (each pair's positions, two (ny, nx) planes) are stored at
``map_dtype`` "f64" or "f32" (the JAX package's PYIMCOM_DESTRIPE_MAP_DTYPE:
the kernels widen float32 positions to float64 as they read them, so the
cost is that of the float64 route on the widened maps), and in
``map_store`` "device" (every pair on the card, 16 or 8 bytes a pixel a
pair) or "host": the maps stay in pageable host memory (the memory-mapped
files of ``imdestripe.DestripeProblem(memmap=True)``, viewed in place, or
one host copy at the stored dtype) and go up pair by pair through two
staging slots on the device, the next pair's upload on a side stream while
the current pair computes (:class:`PairMaps`).  The card
then holds maps for two pairs while a pass walks them, and none between
passes, whatever the number of pairs.  The host route runs its pair loop in
one autograd function (:class:`_StreamedPairs`) whose backward walks the
pairs in reverse and uploads each again; saving the positions for the
backward, as BilinearGather does, would keep every pair on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DTYPE, resolve_device
from .bilinear import (
    BilinearGather,
    bilinear_gather,
    bilinear_gather_plain,
    bilinear_scatter_adjoint,
    in_bounds,
)
from .bilinear_cuda import build_adjoint_plan, check_plans

# the storage of the pair maps: their dtype, and where they live
MAP_DTYPES = {"f64": torch.float64, "f32": torch.float32}
MAP_STORES = ("device", "host")
_NUMPY = {torch.float64: np.dtype(np.float64), torch.float32: np.dtype(np.float32)}


def _stripe_forward(p, ny: int, nx: int, amp_cols):
    """Stripe image of one SCA's parameter vector (imdestripe.forward_par):
    a row offset broadcast along each row, plus one offset a column block
    with `amp_cols`."""
    img = p[:ny, None].expand(ny, nx)
    if amp_cols:
        nblk = nx // amp_cols
        cols = p[ny:ny + nblk].repeat_interleave(amp_cols)
        cols = torch.cat([cols, cols.new_zeros(nx - nblk * amp_cols)])
        img = img + cols[None, :]
    return img


def _penalty(r, model: str, hub: float):
    if model in (None, "quadratic"):
        return 0.5 * r * r
    if model == "absolute":
        return torch.abs(r)
    if model == "huber_loss":
        a = torch.abs(r)
        return torch.where(a <= hub, 0.5 * r * r, hub * (a - 0.5 * hub))
    raise ValueError(f"unknown cost model {model!r}")


def boundary_chunks(bmasks, targets, ny: int, nx: int, amp_cols, chunk_width: int = 50,
                    chunk_height: int = 100):
    """The amplifier-boundary chunks of the targets whose masks are nonempty
    on both sides: (i, c0, c1, lo, mid, hi, n_left, n_right) each, in host
    NumPy.  They depend on the masks alone, so the cost has no
    data-dependent control flow."""
    out = []
    for i in targets:
        mi = bmasks[i] if bmasks[i] is not None else np.ones((ny, nx), bool)
        for b in range(1, nx // amp_cols):
            lo = max(b * amp_cols - chunk_width, 0)
            hi = min(b * amp_cols + chunk_width, nx)
            for c0 in range(0, ny, 4 * chunk_height):
                c1 = min(c0 + chunk_height, ny)
                lm = mi[c0:c1, lo:b * amp_cols]
                rm = mi[c0:c1, b * amp_cols:hi]
                if lm.any() and rm.any():
                    out.append((i, c0, c1, lo, b * amp_cols, hi, float(lm.sum()),
                                float(rm.sum())))
    return out


def _host_map(a, ny: int, nx: int, dtype=None) -> torch.Tensor:
    """One pair map as a (ny, nx) host tensor: a view of `a` where it can be
    one (a memory-mapped array stays a view of its file), else a copy at
    `dtype` (default: `a`'s own)."""
    return torch.from_numpy(np.asarray(a, dtype=None if dtype is None else _NUMPY[dtype])
                            .reshape(ny, nx))


class PairMaps:
    """
    Pair maps kept in host memory, uploaded to the device pair by pair.

    xf, yf : P host tensors (ny, nx) of one dtype (pageable, such as views
        of memory-mapped files, or pinned).
    device : where the positions are used.

    :meth:`walk` allocates two staging slots on the device, which hold two
    pairs' positions, and frees them when it ends: between walks the device
    holds no map.  On a CUDA device each upload runs on a side stream, after
    the last work that used its slot's memory (the work the current stream
    had queued when the walk began, then the last read of the slot), and
    the current stream waits for it before the slot is read; :meth:`walk`
    starts the next pair's upload as soon as the caller has enqueued its
    work on the current one.  An upload from pageable memory returns once
    the CUDA runtime has staged it, so the host copies the next pair while the
    device runs the current one.  `uploads` counts the pairs uploaded.
    """

    def __init__(self, xf, yf, device):
        self.xf, self.yf = xf, yf
        self.device = torch.device(device)
        self.slots = None
        self.uploads = 0
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.side = torch.cuda.Stream(self.device)
            self.ready = [torch.cuda.Event(), torch.cuda.Event()]

    def _stage(self, p: int, slot: int) -> None:
        dst = self.slots[slot]
        if self.cuda:
            with torch.cuda.stream(self.side):
                if self.free[slot] is not None:
                    self.side.wait_event(self.free[slot])
                dst[0].copy_(self.xf[p], non_blocking=True)
                dst[1].copy_(self.yf[p], non_blocking=True)
                self.ready[slot].record(self.side)
        else:
            dst[0].copy_(self.xf[p])
            dst[1].copy_(self.yf[p])
        self.uploads += 1

    def walk(self, order):
        """Yield (p, x, y) for each pair p of `order`, its positions in a
        staging slot on the device.  The caller enqueues all its work on
        (x, y) before it asks for the next pair, whose slot is then
        refilled.  The slots are freed when the walk ends, after the
        current stream has waited for every upload (a walk left early may
        still have one in flight), so they are its to reuse."""
        order = list(order)
        if not order:
            return
        ny, nx = self.xf[0].shape
        self.slots = torch.empty((2, 2, ny, nx), dtype=self.xf[0].dtype, device=self.device)
        # the allocator hands out memory whose last use on the current stream
        # may still be queued: the side stream's first uploads wait for it
        start = (torch.cuda.current_stream(self.device).record_event() if self.cuda
                 else None)
        self.free = [start, start]
        try:
            slot = 0
            self._stage(order[0], slot)
            for k, p in enumerate(order):
                if self.cuda:
                    torch.cuda.current_stream(self.device).wait_event(self.ready[slot])
                yield p, self.slots[slot, 0], self.slots[slot, 1]
                if self.cuda:
                    self.free[slot] = torch.cuda.current_stream(self.device).record_event()
                slot = 1 - slot
                if k + 1 < len(order):
                    self._stage(order[k + 1], slot)
        finally:
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_stream(self.side)
            self.slots = None


class _StreamedPairs(torch.autograd.Function):
    """
    ``_StreamedPairs.apply(cost, *imgs)``: every pair gather of a cost whose
    maps live in host memory, added into one accumulator a target (returned
    in ``cost.targets`` order), the pairs in order as the device route adds
    them.  The backward walks the pairs in reverse, uploading each again,
    and K4 adds each pair's adjoint straight into its source image's
    gradient (no plane a pair).  It saves nothing: the gathers are linear in
    the images.
    """

    @staticmethod
    def forward(ctx, cost, *imgs):
        ctx.cost = cost
        acc = {i: imgs[0].new_zeros((cost.ny, cost.nx)) for i in cost.targets}
        for p, x, y in cost.maps.walk(range(len(cost.pairs))):
            i, j = cost.pairs[p]
            bilinear_gather(imgs[j], x, y, cost.ge[j], out=acc[i])
        return tuple(acc[i] for i in cost.targets)

    @staticmethod
    def backward(ctx, *grads):
        cost = ctx.cost
        g_acc = dict(zip(cost.targets, grads))
        g_img = [None] * cost.S
        for p, x, y in cost.maps.walk(reversed(range(len(cost.pairs)))):
            i, j = cost.pairs[p]
            if g_img[j] is None:
                g_img[j] = g_acc[i].new_zeros((cost.ny, cost.nx))
            bilinear_scatter_adjoint(g_acc[i].contiguous(), x, y, (cost.ny, cost.nx),
                                     cost.ge[j], out=g_img[j], plan=cost.plans[p])
        return (None, *g_img)


def _pair_plan(x, y, shape):
    """K4's plan of a pair's maps x, y on a `shape` target where K4 runs
    over it, on a CUDA device; None on the CPU, whose plain adjoint takes
    no plan."""
    return build_adjoint_plan(x, y, shape) if x.is_cuda else None


class DestripeCost(torch.nn.Module):
    """
    The destriping cost of :class:`~pyimcom_tpu_torch.imdestripe.
    DestripeProblem`-shaped data, resident on one device.

    Parameters
    ----------
    imgs : (S, ny, nx) original SCA images.
    g_eff : (S, ny, nx) effective gain maps.
    masks : (S, ny, nx) bool (True = use pixel) or None.
    pairs : list of ordered (i, j) -- SCA j interpolates onto SCA i's grid.
    xf, yf : P arrays of ny*nx values, (ny, nx) grids or flat (or one
        array of P of them): the positions of SCA i's pixels in SCA j's
        frame, pair by pair, in row-major pixel order.
    amp_cols, cost_model, hub, col_boundary_const : as in DestripeProblem.
    bmasks : the S masks of the boundary penalty (default `masks`).
    device : where the buffers live and the cost runs ("cuda" by default).
    map_dtype : "f64" (default) or "f32": the maps' stored width (given
        maps of another dtype are converted, rounding to nearest).
    map_store : "device" (default: every pair on the device) or "host"
        (:class:`PairMaps`, from pageable host memory: a given map of the
        stored dtype, a memory-mapped array too, is viewed in place, any
        other is copied to the host at that dtype).

    ``forward(params)`` is the cost eps, a 0-d tensor, differentiable in
    params (S * n_params,); ``value_and_grad`` gives both on the device,
    ``cost`` and ``cost_and_grad`` take and return numpy as the JAX
    package's ``DeviceDestripe`` does.

    On a CUDA device two gradients at the same params are the same bits
    where every pair's K4 runs over its plan; a pair whose plan overflowed
    takes K4's off-plan body, whose atomics add in no fixed order, so its
    gradient matches the plain route within the destripe bounds (cost rtol
    1e-12, gradient rtol 1e-9, atol 1e-12), not bit for bit.
    """

    def __init__(self, imgs, g_eff, masks, pairs, xf, yf, amp_cols=None,
                 cost_model="quadratic", hub=1.0, col_boundary_const=0.0, chunk_width=50,
                 chunk_height=100, bmasks=None, device="cuda", map_dtype="f64",
                 map_store="device"):
        super().__init__()
        dev = resolve_device(device)
        if map_dtype not in MAP_DTYPES:
            raise ValueError(f"map_dtype must be one of {sorted(MAP_DTYPES)}, got {map_dtype!r}")
        if map_store not in MAP_STORES:
            raise ValueError(f"map_store must be one of {MAP_STORES}, got {map_store!r}")
        self.map_dtype, self.map_store = map_dtype, map_store
        S, ny, nx = np.shape(imgs)
        self.S, self.ny, self.nx = S, ny, nx
        self.amp_cols = amp_cols
        self.np_each = ny + (nx // amp_cols if amp_cols else 0)
        self.pairs = [(int(i), int(j)) for i, j in pairs]
        self.targets = sorted({i for i, _ in self.pairs})
        self.cost_model = cost_model
        self.hub = float(hub)
        self.cbc = float(col_boundary_const)

        def put(a, dtype=DTYPE):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.register_buffer("imgs", put(imgs))
        self.register_buffer("ge", put(g_eff))
        # the maps go up (or are stored) pair by pair, never stacked on the host
        mdt = MAP_DTYPES[map_dtype]
        cnt = torch.zeros((S, ny, nx), dtype=DTYPE, device=dev)
        if map_store == "device":
            for name, arrs in (("xf", xf), ("yf", yf)):
                t = torch.empty((len(self.pairs), ny, nx), dtype=mdt, device=dev)
                for p in range(len(self.pairs)):
                    t[p].copy_(_host_map(arrs[p], ny, nx))
                self.register_buffer(name, t)
            self.maps = None
            walk = ((p, self.xf[p], self.yf[p]) for p in range(len(self.pairs)))
        else:
            self.xf = [_host_map(a, ny, nx, mdt) for a in xf]
            self.yf = [_host_map(a, ny, nx, mdt) for a in yf]
            self.maps = PairMaps(self.xf, self.yf, dev) if self.pairs else None
            walk = self.maps.walk(range(len(self.pairs))) if self.pairs else ()
        # hit counts of each target pixel and K4's plan of each pair (built
        # while the maps stream up): where no hit, J is 0 and r is 0
        self.plans = []
        for p, x, y in walk:
            cnt[self.pairs[p][0]] += in_bounds(x, y, (ny, nx))
            self.plans.append(_pair_plan(x, y, (ny, nx)))
        # every plan's counts, and so its route, in one read-back
        check_plans(self.plans)
        valid = cnt > 0
        mask = put(masks, torch.bool) if masks is not None else torch.ones_like(valid)
        self.register_buffer("cnt", torch.where(valid, cnt, 1.0))
        self.register_buffer("use", valid & mask.reshape(S, ny, nx))
        self.chunks = []
        if amp_cols and self.cbc > 0:
            if bmasks is None:
                bmasks = masks if masks is not None else [None] * S
            bm = [None if m is None else np.asarray(m, bool) for m in bmasks]
            self.chunks = boundary_chunks(bm, self.targets, ny, nx, amp_cols, chunk_width,
                                          chunk_height)
            self.register_buffer("bmask", torch.stack(
                [torch.ones((ny, nx), dtype=torch.bool, device=dev) if m is None
                 else put(m, torch.bool) for m in bm]))

    # ---- the differentiable cost ---------------------------------------
    def _plain_pair(self, img, p: int):
        """The plain gather of pair p's source image `img`; the positions
        are the stored planes or, with host storage, uploaded afresh."""
        _i, j = self.pairs[p]
        x, y = self.xf[p], self.yf[p]
        if self.map_store == "host":
            x, y = x.to(img.device), y.to(img.device)
        return bilinear_gather_plain(img, x, y, self.ge[j])

    def forward(self, params: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The cost at `params`.  `plain` runs the pair gather as its plain
        PyTorch version differentiated by autograd, each pair (and, with host
        storage, its upload) recomputed in the backward
        (torch.utils.checkpoint), instead of K3 and K4: the route the
        kernels are held against."""
        S, ny, nx = self.S, self.ny, self.nx
        ps = params.reshape(S, self.np_each)
        imgs = [self.imgs[s] - _stripe_forward(ps[s], ny, nx, self.amp_cols) for s in range(S)]
        if self.map_store == "host" and not plain and self.pairs:
            acc = dict(zip(self.targets, _StreamedPairs.apply(self, *imgs)))
        else:
            acc = {i: torch.zeros((ny, nx), dtype=params.dtype, device=params.device)
                   for i in self.targets}
        for p, (i, j) in enumerate(self.pairs):
            if plain:
                acc[i] = acc[i] + checkpoint(self._plain_pair, imgs[j], p, use_reentrant=False)
            elif self.map_store == "device":
                acc[i] = BilinearGather.apply(imgs[j], self.xf[p], self.yf[p], self.ge[j],
                                              acc[i], self.plans[p])
        eps = params.new_zeros(())
        for i in self.targets:
            J = acc[i] / self.cnt[i]
            r = torch.where(self.use[i], imgs[i] - J, 0.0)
            eps = eps + torch.sum(_penalty(r, self.cost_model, self.hub))
        for (i, c0, c1, lo, mid, hi, nl, nr) in self.chunks:
            lm = self.bmask[i, c0:c1, lo:mid]
            rm = self.bmask[i, c0:c1, mid:hi]
            lmean = torch.sum(torch.where(lm, imgs[i][c0:c1, lo:mid], 0.0)) / nl
            rmean = torch.sum(torch.where(rm, imgs[i][c0:c1, mid:hi], 0.0)) / nr
            eps = eps + self.cbc * (lmean - rmean) ** 2
        return eps

    # ---- public API ------------------------------------------------------
    def _params(self, params) -> torch.Tensor:
        return torch.as_tensor(np.asarray(params, np.float64), device=self.imgs.device)

    def value_and_grad(self, params: torch.Tensor, plain: bool = False):
        """(eps, d eps / d params) as tensors on the device, without waiting
        for it."""
        p = params.detach().requires_grad_(True)
        eps = self(p, plain=plain)
        if not eps.requires_grad:               # no pair: the cost is 0
            return eps.detach(), torch.zeros_like(p)
        (g,) = torch.autograd.grad(eps, p)
        return eps.detach(), g

    def cost(self, params) -> float:
        with torch.no_grad():
            return float(self(self._params(params)))

    def cost_and_grad(self, params):
        eps, g = self.value_and_grad(self._params(params))
        return float(eps), g.cpu().numpy()
