"""The vector work of an unpreconditioned CG iteration: wrappers over the
three CUDA kernels of ``csrc/cg_update.cu``, and their plain torch versions.

Replaces no Pallas kernel: the reference's CG (``spmv_tpu/solvers/cg.py``)
is a ``lax.while_loop`` of jnp ops. ``solvers/cg.py``'s torch loop makes 19
passes over n-vectors an iteration for that work; the kernels make 10 and
keep the iteration's scalars on the card (``Workspace.scalars``):

- ``cg_pap(p, ap, ws)``: alpha = rho / (p.Ap);
- ``cg_update_r(r, ap, ws, rtol)``: r -= alpha Ap in place; rho' = r.r;
  beta = rho' / rho; the convergence flag |r| / max(rnorm0, tiny) >= rtol
  (in the vectors' dtype); rho = rho';
- ``cg_update_xp(x, p, r, ws)``: x += alpha p and p = r + beta p in place.

They are bound by bytes (10 n itemsize an iteration); their design removes
the intermediates the torch loop writes out and reads back. Vectors are
taken flat, contiguous and of one real dtype (float32 or float64), so the
dots run over every stacked shard at once.

A CPU tensor takes the plain torch version (the torch loop's arithmetic,
op for op); a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches by kernel (none on the plain path).
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# the slots of the scalar buffer (csrc/cg_update.cu: kRho .. kFlag)
RHO, ALPHA, BETA, RNORM0, FLAG = range(5)
THREADS = 256              # a kernel block
THREADS_PER_SM = 2048      # the most an SM holds, so partials enough for
#                            every block resident at once

launches = {"cg_pap": 0, "cg_update_r": 0, "cg_update_xp": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


@dataclasses.dataclass
class Workspace:
    """One solve's scalars and reduction scratch, on the vectors' device."""

    scalars: torch.Tensor   # (5,) in the vectors' dtype: rho, alpha, beta,
    #                         rnorm0, flag (1 while not converged)
    partials: torch.Tensor  # (blocks,) float64: a block's partial sum
    ticket: torch.Tensor    # (1,) int32: blocks done, 0 between launches
    rho: torch.Tensor       # 0-d views of scalars
    flag: torch.Tensor


def workspace(rho: torch.Tensor, rnorm0: torch.Tensor) -> Workspace:
    """Scalars holding ``rho`` (r.r) and ``rnorm0``, and the kernels'
    scratch, allocated once per solve."""
    dev = rho.device
    scalars = torch.zeros(5, dtype=rho.dtype, device=dev)
    scalars[RHO] = rho
    scalars[RNORM0] = rnorm0
    blocks = 1
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = sms * (THREADS_PER_SM // THREADS)
    return Workspace(
        scalars=scalars,
        partials=torch.empty(blocks, dtype=torch.float64, device=dev),
        ticket=torch.zeros(1, dtype=torch.int32, device=dev),
        rho=scalars[RHO], flag=scalars[FLAG])


def _check(ws: Workspace, *vecs: torch.Tensor) -> None:
    s = ws.scalars
    if s.dtype not in DTYPES:
        raise TypeError(f"CG update takes float32 or float64 vectors, got {s.dtype}")
    n = vecs[0].numel()
    for v in vecs:
        if v.dtype != s.dtype or v.device != s.device:
            raise TypeError(f"CG update vectors must be {s.dtype} on {s.device}, "
                            f"got {v.dtype} on {v.device}")
        if v.numel() != n or not v.is_contiguous():
            raise ValueError("CG update takes contiguous vectors of one size, got "
                             f"{[(tuple(t.shape), t.is_contiguous()) for t in vecs]}")


def _launch(name: str, ws: Workspace, args: tuple) -> None:
    from spmv_torch._build import load_library

    lib = load_library()
    entry = f"{name}_{DTYPES[ws.scalars.dtype]}"
    dev = ws.scalars.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    launches[name] += 1


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.vdot(u.reshape(-1), v.reshape(-1))


def cg_pap_plain(p: torch.Tensor, ap: torch.Tensor, ws: Workspace) -> None:
    s = ws.scalars
    s[ALPHA] = s[RHO] / _dot(p, ap)


def cg_update_r_plain(r: torch.Tensor, ap: torch.Tensor, ws: Workspace,
                      rtol: float) -> None:
    s = ws.scalars
    r.sub_(s[ALPHA] * ap)
    rho = _dot(r, r)
    s[BETA] = rho / s[RHO]
    eps = torch.finfo(s.dtype).tiny
    s[FLAG] = torch.sqrt(rho) / torch.clamp(s[RNORM0], min=eps) >= rtol
    s[RHO] = rho


def cg_update_xp_plain(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                       ws: Workspace) -> None:
    s = ws.scalars
    x.add_(s[ALPHA] * p)
    p.mul_(s[BETA]).add_(r)


def cg_pap(p: torch.Tensor, ap: torch.Tensor, ws: Workspace) -> None:
    """alpha = rho / (p.Ap), into ``ws``."""
    _check(ws, p, ap)
    if p.device.type == "cpu":
        return cg_pap_plain(p, ap, ws)
    _launch("cg_pap", ws, (p.data_ptr(), ap.data_ptr(), p.numel(),
                           ws.scalars.data_ptr(), ws.partials.data_ptr(),
                           ws.ticket.data_ptr(), ws.partials.numel()))


def cg_update_r(r: torch.Tensor, ap: torch.Tensor, ws: Workspace,
                rtol: float) -> None:
    """r -= alpha Ap in place; beta, the flag and the new rho into ``ws``."""
    _check(ws, r, ap)
    if r.device.type == "cpu":
        return cg_update_r_plain(r, ap, ws, rtol)
    _launch("cg_update_r", ws, (r.data_ptr(), ap.data_ptr(), r.numel(),
                                ws.scalars.data_ptr(), ws.partials.data_ptr(),
                                ws.ticket.data_ptr(), ws.partials.numel(),
                                float(rtol)))


def cg_update_xp(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                 ws: Workspace) -> None:
    """x += alpha p and p = r + beta p, in place, from one read of p."""
    _check(ws, x, p, r)
    if x.device.type == "cpu":
        return cg_update_xp_plain(x, p, r, ws)
    _launch("cg_update_xp", ws, (x.data_ptr(), p.data_ptr(), r.data_ptr(),
                                 x.numel(), ws.scalars.data_ptr(),
                                 ws.partials.numel()))
