"""The fused CG loop (``solvers/cg._cg_fused``) and its three update
kernels (``ops/cg_update_cuda.py``, ``csrc/cg_update.cu``).

On the CPU: each plain version repeats the torch loop's arithmetic op for
op, so the fused loop run through them gives the torch loop's bits; and
``cg`` routes a solve by its device, dtype and preconditioner alone.

On the card (the ``cuda`` marker; this file imports no jax, so run it
there with ``python -m pytest tests/test_torch_cg_update.py -m cuda
--noconftest``): the fused loop against the torch loop, iteration counts
equal, solutions and residual norms within a stated tolerance, its own
runs bit for bit, its inputs untouched, three launches an iteration.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from spmv_torch.gen import create_laplace_2d
from spmv_torch.ops import cg_update_cuda
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers import cg as cg_module

DTYPES = [np.float32, np.float64]
CASES = ["zero", "x0", "resume", "early"]
# fused against torch loop on the card, relative: the kernels sum the dots
# in another order (in float64 for float32 vectors) and round x + alpha p,
# r - alpha Ap and r + beta p once (an fma) where torch rounds twice. A CPU
# model of that arithmetic (float64 dots and single roundings) moved
# float32 solutions by at most 4.1e-7 and |r| by 1.03e-6 over 100-563
# iterations at 64² and 256²; float64 rounds 2^29 times finer.
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_cg_update.py -m cuda --noconftest)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counters():
    cg_update_cuda.reset_launches()
    yield
    cg_update_cuda.reset_launches()


def _operator(n: int, dt, nd: int, device):
    A = build_dist_matrix(create_laplace_2d(n, n), n_devices=nd, symmetric=True,
                          local_format="dia", dtype=dt, device=device)
    rng = np.random.default_rng(n + nd)
    b = A.to_dist(rng.uniform(-1.0, 1.0, n * n).astype(dt))
    x0 = A.to_dist(rng.uniform(-1.0, 1.0, n * n).astype(dt))
    return A, b, x0


def _solve(loop, A, b, x0, case: str) -> list:
    """The case's solves through ``loop(matvec, b, x0, kmax, rtol,
    resume=)``: 100 iterations from zero or from x0; 30 then 70 resumed;
    rtol 1e-3, which stops early (105 and 359 iterations at 64² and 256²)."""
    if case == "zero":
        return [loop(A.matvec, b, None, 100, 0.0)]
    if case == "x0":
        return [loop(A.matvec, b, x0, 100, 0.0)]
    if case == "early":
        return [loop(A.matvec, b, None, 1000, 1e-3)]
    first = loop(A.matvec, b, None, 30, 0.0)
    keep = [t.clone() for t in (first.x, first.r, first.p, first.rnorm0)]
    second = loop(A.matvec, b, first.x, 70, 0.0, resume=(first.r, first.p, first.rnorm0))
    for t, kept in zip((first.x, first.r, first.p, first.rnorm0), keep):
        assert torch.equal(t, kept)  # the resume state is not written
    return [first, second]


def _plain(matvec, b, x0, kmax, rtol, resume=None):
    return cg_module._cg_plain(matvec, b, x0, kmax, rtol, None, resume)


def _fused(matvec, b, x0, kmax, rtol, resume=None):
    return cg_module._cg_fused(matvec, b, x0, kmax, rtol, resume)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


# --- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", [(3, 128), (2, 3, 128)], ids=["flat", "stacked"])
@pytest.mark.parametrize("rtol", [1e-6, 10.0], ids=["going", "converged"])
def test_plain_versions_repeat_the_torch_loop(dt, shape, rtol):
    gen = torch.Generator().manual_seed(7)
    dtype = torch.float32 if dt == np.float32 else torch.float64
    x, p, r, ap = (torch.rand(shape, generator=gen, dtype=dtype) for _ in range(4))
    rho, rnorm0 = cg_module._dot(r, r), torch.tensor(3.0, dtype=dtype)
    eps = torch.finfo(dtype).tiny
    # one iteration of the torch loop, as solvers/cg.py writes it
    alpha = rho / cg_module._dot(p, ap)
    x_want = x + alpha * p
    r_want = r - alpha * ap
    rho_new = cg_module._dot(r_want, r_want)
    beta = rho_new / rho
    p_want = r_want + beta * p
    flag = cg_module._rel(rho_new, rnorm0, eps) >= rtol

    ws = cg_update_cuda.workspace(rho, rnorm0)
    cg_update_cuda.cg_pap(p, ap, ws)
    cg_update_cuda.cg_update_r(r, ap, ws, rtol)
    cg_update_cuda.cg_update_xp(x, p, r, ws)
    s = ws.scalars
    assert torch.equal(s[cg_update_cuda.ALPHA], alpha)
    assert torch.equal(s[cg_update_cuda.BETA], beta)
    assert torch.equal(ws.rho, rho_new) and torch.equal(s[cg_update_cuda.RNORM0], rnorm0)
    assert bool(ws.flag) == bool(flag) == (rtol < 1.0)
    for got, want in ((x, x_want), (r, r_want), (p, p_want)):
        assert torch.equal(got, want)
    assert sum(cg_update_cuda.launches.values()) == 0


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_fused_loop_gives_the_torch_loops_bits_on_cpu(dt, nd, case):
    """Through the plain versions (the CPU path of each wrapper) the fused
    loop computes what the torch loop computes, bit for bit."""
    A, b, x0 = _operator(24, dt, nd, "cpu")
    b_kept, x0_kept = b.clone(), x0.clone()
    fused = _solve(_fused, A, b, x0, case)
    plain = _solve(_plain, A, b, x0, case)
    for f, p in zip(fused, plain):
        assert f.iterations == p.iterations and f.converged == p.converged
        for a, c in ((f.x, p.x), (f.rnorm, p.rnorm), (f.rnorm0, p.rnorm0),
                     (f.r, p.r), (f.p, p.p)):
            assert torch.equal(a, c)
    assert torch.equal(b, b_kept) and torch.equal(x0, x0_kept)


@pytest.mark.parametrize("device,dtype,precond,fused", [
    ("cuda", torch.float64, False, True),
    ("cuda", torch.float32, False, True),
    ("cuda", torch.float32, True, False),
    ("cuda", torch.complex128, False, False),
    ("cuda", torch.bfloat16, False, False),
    ("cpu", torch.float64, False, False),
])
def test_route_follows_device_dtype_and_preconditioner(device, dtype, precond, fused):
    b = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert cg_module._takes_fused(b, (lambda r: r) if precond else None) is fused


@pytest.mark.parametrize("case", ["float64", "jacobi", "bfloat16"])
def test_cpu_solves_take_the_torch_loop(case):
    before = dict(cg_module.iterations)
    if case == "bfloat16":
        b = torch.ones(256, dtype=torch.bfloat16)
        res = cg_module.cg(lambda v: 2 * v, b, kmax=5)
    else:
        A, b, _ = _operator(16, np.float64, 1, "cpu")
        pre = A.jacobi_preconditioner() if case == "jacobi" else None
        res = cg_module.cg(A.matvec, b, kmax=20, rtol=0.0, preconditioner=pre)
    assert res.iterations >= 1
    assert cg_module.iterations["fused"] == before["fused"]
    assert cg_module.iterations["plain"] == before["plain"] + res.iterations
    assert sum(cg_update_cuda.launches.values()) == 0


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_fused_loop_matches_the_torch_loop_on_cuda(cuda, n, dt, nd, case):
    A, b, x0 = _operator(n, dt, nd, cuda)
    b_kept, x0_kept = b.clone(), x0.clone()
    its = dict(cg_module.iterations)
    fused = _solve(cg_module.cg, A, b, x0, case)
    k = sum(f.iterations for f in fused)
    assert cg_module.iterations["fused"] == its["fused"] + k
    assert cg_module.iterations["plain"] == its["plain"]
    assert cg_update_cuda.launches == {"cg_pap": k, "cg_update_r": k,
                                       "cg_update_xp": k}
    plain = _solve(_plain, A, b, x0, case)
    again = _solve(cg_module.cg, A, b, x0, case)
    for f, p, g in zip(fused, plain, again):
        assert f.iterations == p.iterations and f.converged == p.converged
        assert f.rnorm.shape == f.rnorm0.shape == ()
        assert _rel(f.x, p.x) <= TOL[dt]
        assert _rel(f.rnorm, p.rnorm) <= TOL[dt]
        for a, c in ((f.x, g.x), (f.rnorm, g.rnorm), (f.r, g.r), (f.p, g.p)):
            assert torch.equal(a, c)  # the fused loop's own runs: same bits
    assert torch.equal(b, b_kept) and torch.equal(x0, x0_kept)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1_000_003, 0), (1_000_003, 1)],
                         ids=["packs", "tail", "unaligned"])
def test_update_kernels_match_plain_on_cuda(cuda, dt, n, offset):
    """One iteration's three kernels against their plain versions on the
    same inputs: 16-byte packs, a ragged tail, and vectors one entry off
    16-byte alignment (scalar loads). The kernels' scalars within a few
    roundings of the plain versions' (float64 dots of float32 vectors, sums
    in another order), their vectors within an fma's rounding of the plain
    arithmetic given the same scalars."""
    dtype = torch.float32 if dt == np.float32 else torch.float64
    gen = torch.Generator(device=cuda).manual_seed(11)
    vecs = [torch.rand(n + offset, generator=gen, dtype=dtype, device=cuda)[offset:]
            for _ in range(4)]
    rho = cg_module._dot(vecs[2], vecs[2])
    rnorm0 = torch.sqrt(rho) * 2
    kern = [v.clone() for v in vecs] if offset == 0 else [
        torch.empty(n + 1, dtype=dtype, device=cuda)[1:].copy_(v) for v in vecs]
    plain = [v.clone() for v in vecs]
    ws_k, ws_p = (cg_update_cuda.workspace(rho, rnorm0) for _ in range(2))
    x, p, r, ap = kern
    cg_update_cuda.cg_pap(p, ap, ws_k)
    cg_update_cuda.cg_update_r(r, ap, ws_k, 0.3)
    cg_update_cuda.cg_update_xp(x, p, r, ws_k)
    xp, pp, rp, app = plain
    cg_update_cuda.cg_pap_plain(pp, app, ws_p)
    cg_update_cuda.cg_update_r_plain(rp, app, ws_p, 0.3)
    torch.cuda.synchronize()
    assert cg_update_cuda.launches == {"cg_pap": 1, "cg_update_r": 1, "cg_update_xp": 1}
    sk, sp = ws_k.scalars.double(), ws_p.scalars.double()
    tol = 1e-5 if dt == np.float32 else 1e-12
    for slot in (cg_update_cuda.ALPHA, cg_update_cuda.RHO, cg_update_cuda.BETA):
        assert abs(float(sk[slot] - sp[slot])) <= tol * abs(float(sp[slot]))
    assert float(sk[cg_update_cuda.FLAG]) == float(sp[cg_update_cuda.FLAG])
    # the vectors, from the kernels' own scalars
    alpha, beta = ws_k.scalars[cg_update_cuda.ALPHA], ws_k.scalars[cg_update_cuda.BETA]
    r_want = vecs[2] - alpha * vecs[3]
    assert _rel(r, r_want) <= 4 * torch.finfo(dtype).eps
    assert _rel(x, vecs[0] + alpha * vecs[1]) <= 4 * torch.finfo(dtype).eps
    assert _rel(p, r + beta * vecs[1]) <= 4 * torch.finfo(dtype).eps
    assert int(ws_k.ticket) == 0


@pytest.mark.cuda
def test_card_solves_route_by_dtype_and_preconditioner(cuda):
    A, b, _ = _operator(64, np.float64, 1, cuda)
    before = dict(cg_module.iterations)
    res = cg_module.cg(A.matvec, b, kmax=20, rtol=0.0,
                       preconditioner=A.jacobi_preconditioner())
    b16 = torch.ones(4096, dtype=torch.bfloat16, device=cuda)
    res16 = cg_module.cg(lambda v: 2 * v, b16, kmax=5)
    assert cg_module.iterations["fused"] == before["fused"]
    assert cg_module.iterations["plain"] == (before["plain"] + res.iterations
                                             + res16.iterations)
    assert sum(cg_update_cuda.launches.values()) == 0
    res32 = cg_module.cg(lambda v: 2 * v, b16.float(), kmax=5)
    assert cg_module.iterations["fused"] == before["fused"] + res32.iterations
    assert cg_update_cuda.launches["cg_pap"] == res32.iterations >= 1
