"""
Several local devices for the stamp solves of one block.

Counterpart of pyimcom_tpu/parallel/mesh.py.  The JAX package shards a
round's stamp systems over a ``jax.sharding.Mesh`` (``shard_map``) and
reduces the block's quality statistics with ``pmax`` / ``psum``
collectives.  Here one process drives every local card, as the JAX
package's one process drives its mesh: the "mesh" is a list of
``torch.device`` s, each group (or shard of stamps) is solved on its own
device with the port's solve (``ops.assemble.solve_finalize_batch``,
cuSOLVER / cuBLAS on a card), which PyTorch enqueues on that device's
stream without waiting, and each device keeps its partial statistics there
-- the largest U/C and Sigma and the sum of Sigma, one (3,) tensor.  The
partials are reduced on the host (:func:`reduce_stats`) when the round
drains, so nothing waits mid-round; the JAX package's collectives become
that host reduction.  No ``torch.distributed``: the devices are local, and
no hand-written kernel is needed.

A list that repeats a device (``[cpu] * 4``, ``[cuda:0] * 2``) runs the same
code; that is how the CPU tests and a one-card machine exercise it.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..device import DTYPE, resolve_device


def make_mesh(n_devices: int | None = None, device="cuda") -> list[torch.device]:
    """The first `n_devices` local cards (all of them by default) as a list
    of torch.devices; for `device` "cpu", the CPU `n_devices` times (once by
    default).  Asking for more cards than the machine has raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [resolve_device(dev)] * max(1, n_devices or 1)
    resolve_device(dev)
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} CUDA devices, the machine has {count}")
    return [torch.device("cuda", k) for k in range(n)]


def on_device(dev: torch.device):
    """A context that makes `dev` the current CUDA device (nothing for the
    CPU), so that work enqueued inside it, CUDA events included, runs on
    `dev`'s current stream."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _partials(UC: torch.Tensor, Sigma: torch.Tensor) -> torch.Tensor:
    """(3,) on the device: max U/C, max Sigma, sum of Sigma."""
    return torch.stack([UC.max(), Sigma.max(), Sigma.sum()])


def reduce_stats(partials) -> dict:
    """The quality statistics over every device's partials (the JAX
    package's pmax / pmax / psum): {"uc_max", "sigma_max", "sigma_sum"} as
    floats."""
    host = np.stack([p.detach().cpu().numpy() for p in partials])
    return {"uc_max": float(host[:, 0].max()), "sigma_max": float(host[:, 1].max()),
            "sigma_sum": float(host[:, 2].sum())}


def solve_finalize_mesh(devices, parts, ucmin: float, smax: float, rtol: float, n2sq: int,
                        solver: str, exact_UC: bool, maxiter: int, no_qlt_ctrl: bool = False):
    """
    Solve and coadd one round of stamp groups, each on its own device.

    devices : one torch.device a group (it may repeat).
    parts : one dict a group, the inputs of ops.assemble.solve_finalize_batch
        on that group's device: "A", "mBhalf", "C", "kappaC", "data",
        "img_onehot", "fade", "relevant", "dist" (None but for Empirical)
        and "rho_acc" (read by Empirical only; 0 if absent).
    The other arguments are solve_finalize_batch's, shared by the round.

    Returns (outs, partials): each group's output dict on its device, and
    each device's (3,) partial statistics, still on the device; reduce them
    with :func:`reduce_stats` when the round drains.  Groups may differ in
    stamp count and system size: each is solved at its own.
    """
    outs, partials = [], []
    for dev, part in zip(devices, parts):
        with on_device(dev):
            out = solve_part(part, ucmin, smax, rtol, n2sq, solver, exact_UC, maxiter,
                             no_qlt_ctrl)
            partials.append(_partials(out["UC"], out["Sigma"]))
        outs.append(out)
    return outs, partials


def solve_part(part, ucmin: float, smax: float, rtol: float, n2sq: int, solver: str,
               exact_UC: bool, maxiter: int, no_qlt_ctrl: bool = False) -> dict:
    """One group's ops.assemble.solve_finalize_batch from its `part` (as
    :func:`solve_finalize_mesh` takes them), on the current device, with no
    partial statistics."""
    from ..ops.assemble import solve_finalize_batch

    return solve_finalize_batch(
        part["A"], part["mBhalf"], part["C"], part["kappaC"], part["data"],
        part["img_onehot"], part["fade"], part["relevant"], ucmin, smax, rtol, n2sq,
        solver, exact_UC, maxiter, part.get("dist"), part.get("rho_acc", 0.0), no_qlt_ctrl)


def _put(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=DTYPE).to(dev)


def sharded_stamp_solve(devices, A_batch, mB_batch, C, kappaC, ucmin: float, smax: float):
    """
    Solve a batch of per-stamp systems with the Cholesky kernel, sharded
    over `devices` (contiguous shards of S / len(devices) stamps; S must
    divide evenly, as the JAX package's mesh requires).

    A_batch : (S, n, n); mB_batch : (S, n_out, m, n); C : (n_out,);
    kappaC : (nv,) -- arrays or tensors.

    Returns (T (S, n_out, m, n) on devices[0], stats): stats the globally
    reduced {"uc_max", "sigma_max", "sigma_mean"} as floats, as the JAX
    function returns them.
    """
    from ..solvers import cholesky_solve

    devices = [torch.device(d) for d in devices]
    S, D = int(A_batch.shape[0]), len(devices)
    if S % D:
        raise ValueError(f"{S} stamps do not divide over {D} devices")
    per = S // D
    shards, partials = [], []
    for k, dev in enumerate(devices):
        with on_device(dev):
            A = _put(A_batch[k * per:(k + 1) * per], dev)
            mB = _put(mB_batch[k * per:(k + 1) * per], dev)
            C_, kC_ = _put(C, dev), _put(kappaC, dev)
            outs = [cholesky_solve(A[s], mB[s], C_, kC_, ucmin, smax) for s in range(per)]
            T, Sigma, UC = (torch.stack([o[i] for o in outs]) for i in (0, 2, 3))
            shards.append(T)
            partials.append(_partials(UC, Sigma))
    st = reduce_stats(partials)
    n_out, m = int(mB_batch.shape[1]), int(mB_batch.shape[2])
    stats = {"uc_max": st["uc_max"], "sigma_max": st["sigma_max"],
             "sigma_mean": st["sigma_sum"] / (S * m * n_out)}
    return torch.cat([t.to(devices[0]) for t in shards]), stats
