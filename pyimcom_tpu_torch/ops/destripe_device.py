"""
Device-resident destriping cost and gradient on PyTorch.

Counterpart of pyimcom_tpu/ops/destripe_device.py.  :class:`DestripeCost`
keeps every SCA image, gain map, mask and pair mapping on the device and
writes the whole cost -- stripe model, gain-weighted bilinear resampling of
each neighbour onto its target's grid, penalty model, amplifier
boundary-continuity term -- as one differentiable PyTorch function;
``torch.autograd.grad`` gives its exact gradient, through the gain
weighting too.  The pair gather is :class:`~.bilinear.BilinearGather`
(kernel K3 on the card, its adjoint K4 in the backward), added in place
into the target's accumulator; its positions and the accumulator keep the
target's (ny, nx) pixel grid, which K4 tiles.  It saves no per-pair output
for the backward: the JAX package rematerialises its scan for the same
reason (P saved planes of 4088^2 would add P x 134 MB).  The hit counts and the valid
pixels depend on the maps alone, so they are computed once, when the module
is built.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DTYPE, resolve_device
from .bilinear import BilinearGather, bilinear_gather_plain, in_bounds


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

    ``forward(params)`` is the cost eps, a 0-d tensor, differentiable in
    params (S * n_params,); ``value_and_grad`` gives both on the device,
    ``cost`` and ``cost_and_grad`` take and return numpy as the JAX
    package's ``DeviceDestripe`` does.
    """

    def __init__(self, imgs, g_eff, masks, pairs, xf, yf, amp_cols=None,
                 cost_model="quadratic", hub=1.0, col_boundary_const=0.0, chunk_width=50,
                 chunk_height=100, bmasks=None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
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
        # the maps go up pair by pair, never stacked on the host
        for name, arrs in (("xf", xf), ("yf", yf)):
            t = torch.empty((len(self.pairs), ny, nx), dtype=DTYPE, device=dev)
            for p in range(len(self.pairs)):
                t[p].copy_(torch.as_tensor(np.asarray(arrs[p], np.float64).reshape(ny, nx)))
            self.register_buffer(name, t)
        # hit counts of each target pixel: where none, J is 0 and r is 0
        cnt = torch.zeros((S, ny, nx), dtype=DTYPE, device=dev)
        for p, (i, _j) in enumerate(self.pairs):
            cnt[i] += in_bounds(self.xf[p], self.yf[p], (ny, nx))
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
    def forward(self, params: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The cost at `params`.  `plain` runs the pair gather as its plain
        PyTorch version differentiated by autograd, each pair recomputed in
        the backward (torch.utils.checkpoint), instead of K3 and K4: the
        route the kernels are held against."""
        S, ny, nx = self.S, self.ny, self.nx
        ps = params.reshape(S, self.np_each)
        imgs = [self.imgs[s] - _stripe_forward(ps[s], ny, nx, self.amp_cols) for s in range(S)]
        acc = {i: torch.zeros((ny, nx), dtype=params.dtype, device=params.device)
               for i in self.targets}
        for p, (i, j) in enumerate(self.pairs):
            if plain:
                acc[i] = acc[i] + checkpoint(bilinear_gather_plain, imgs[j], self.xf[p],
                                             self.yf[p], self.ge[j], use_reentrant=False)
            else:
                acc[i] = BilinearGather.apply(imgs[j], self.xf[p], self.yf[p], self.ge[j],
                                              acc[i])
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
