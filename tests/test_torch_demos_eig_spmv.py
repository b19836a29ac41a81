"""spmv_torch's demo_eig and demo_spmv (``--device cpu``) against the
spmv_tpu reference demos (``--cpu``) on the same flags.

Both demos print the same lines: the text of each result line is held
equal with its numbers taken out, and the numbers within the stated
tolerances. demo_eig: LOBPCG eigenvalues within 1e-8 relative where both
converge (each package's small eigenproblems sum in another order) and
the same convergence, iterations within 2; Golub-Kahan singular values
within 1e-12 and the same informative steps; Arnoldi Ritz values within
1e-10; the SLQ log-determinant's exact dense value equal, each
package's estimate within 4 of its own standard errors of it (their
probes come from different generators). demo_spmv: norm(y) after the
100-apply chain within 1e-12 relative in float64, 1e-11 in the
double-single formats (the reference's XLA:CPU contracts its DS product's
cross term; about 4e-15 an apply) and 1e-4 in float32 (each package sums
a row in its own order, and the chain carries the rounding along).
"""
import os
import re
import sys

import jax
import pytest

import spmv_tpu.demos.demo_eig as ref_eig
import spmv_tpu.demos.demo_spmv as ref_spmv

import spmv_torch.demos.demo_eig as pt_eig
import spmv_torch.demos.demo_spmv as pt_spmv
from spmv_torch.gen import create_laplace_2d
from spmv_torch.io.matrix_market import write_matrix_market
from spmv_torch.io.petsc import write_petsc_binary_matrix

NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?(?:[-+](?:\d+\.\d*|\d+)"
                 r"(?:[eE][-+]?\d+)?j)?")


def _results(out: str) -> list[tuple[str, list]]:
    """The result lines after the timings report (the "Total" line): each
    as (text without its numbers, its numbers)."""
    lines = out.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln.startswith("Total")) + 1
    return [(NUM.sub("#", ln), [complex(v) if v.endswith("j") else float(v)
                                for v in NUM.findall(ln)]) for ln in lines[start:]]


def _run(pt_main, ref_mod, name, flags, capsys, monkeypatch):
    """The port's demo on the CPU and the reference's on its CPU backend on
    the same flags: their result lines. jax's backend starts first (the
    reference demo appends its --devices count to XLA_FLAGS)."""
    jax.devices()
    assert pt_main(flags + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [name] + flags + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_mod.main() == 0
    ref = capsys.readouterr().out
    port, ref = _results(port), _results(ref)
    assert [t for t, _ in port] == [t for t, _ in ref]
    return port, ref


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-300)


@pytest.mark.parametrize("flags", [
    ["--lap2d", "20", "-k", "3", "--cheb", "16"],
    ["--lap2d", "16", "-k", "2", "--largest", "--maxiter", "80", "--devices", "2"],
    ["--lap3d", "8", "-k", "2", "--cheb", "8", "--format", "ell"],
])
def test_demo_eig_lobpcg_matches_reference(flags, capsys, monkeypatch):
    port, ref = _run(pt_eig.main, ref_eig, "demo_eig", flags, capsys, monkeypatch)
    # the converged= flag is text, held equal by _run
    (_, (k, its)), (_, (rk, rits)) = port[0], ref[0]
    assert k == rk and abs(its - rits) <= 2
    for (_, (j, th, rel)), (_, (rj, rth, rrel)) in zip(port[1:], ref[1:]):
        assert j == rj and _close(th, rth, 1e-8)
        # the host residuals agree, or both sit below the demo's tol 1e-6
        assert abs(rel - rrel) <= 1e-3 * rrel or max(rel, rrel) <= 1e-6


def test_demo_eig_lobpcg_convergence_flag(capsys, monkeypatch):
    """The same converged= text on a grid where both converge, in float32."""
    flags = ["--lap2d", "12", "-k", "2", "--cheb", "8", "--fp32", "--tol", "1e-4"]
    jax.devices()
    assert pt_eig.main(flags + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["demo_eig"] + flags + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_eig.main() == 0
    ref = capsys.readouterr().out
    assert "converged=True" in port and "converged=True" in ref
    p, r = _results(port), _results(ref)
    for (_, (_j, th, _rel)), (_, (_rj, rth, _rrel)) in zip(p[1:], r[1:]):
        assert _close(th, rth, 1e-5)


def test_demo_eig_svd_matches_reference(capsys, monkeypatch):
    flags = ["--lap2d", "20", "--svd", "30", "-k", "3"]
    port, ref = _run(pt_eig.main, ref_eig, "demo_eig", flags, capsys, monkeypatch)
    assert port[0][1] == ref[0][1]   # (M, informative steps, triplets)
    for (_, (j, s, cert, res)), (_, (rj, rs, rcert, rres)) in zip(port[1:], ref[1:]):
        assert j == rj and _close(s, rs, 1e-12)
        assert _close(cert, rcert, 1e-6) and _close(res, cert, 1e-6)


def test_demo_eig_arnoldi_matches_reference(capsys, monkeypatch):
    flags = ["--convdiff", "20", "--arnoldi", "30", "-k", "4"]
    port, ref = _run(pt_eig.main, ref_eig, "demo_eig", flags, capsys, monkeypatch)
    head, rhead = port[0][1], ref[0][1]
    assert head[:2] == rhead[:2]
    assert all(_close(a, b, 1e-10) for a, b in zip(head[2:], rhead[2:]))
    for (_, (j, th, cert)), (_, (rj, rth, rcert)) in zip(port[1:], ref[1:]):
        assert j == rj and abs(th - rth) <= 1e-10 * abs(rth)
        assert abs(cert - rcert) <= 1e-6 * abs(rcert) + 1e-12


def test_demo_eig_logdet_within_error_bars(capsys, monkeypatch):
    flags = ["--lap2d", "20", "--logdet", "30", "--probes", "12", "--seed", "3"]
    port, ref = _run(pt_eig.main, ref_eig, "demo_eig", flags, capsys, monkeypatch)
    (_, (m, probes, mean, se)), (_, (rm, rprobes, rmean, rse)) = port[0], ref[0]
    (_, (exact, sign, dev)), (_, (rexact, rsign, _rdev)) = port[1], ref[1]
    assert (m, probes, exact, sign) == (rm, rprobes, rexact, rsign)
    assert abs(mean - exact) < 4 * se and abs(rmean - exact) < 4 * rse
    # the printed deviation (two decimals) from the printed mean and stderr
    # (four significant digits)
    assert abs(dev - abs(mean - exact) / se) <= 0.005 + 1e-3 * dev


@pytest.mark.parametrize("source", ["petsc", "mtx"])
def test_demo_eig_reads_files_as_the_reference(source, tmp_path, capsys, monkeypatch):
    a = create_laplace_2d(14, 14)
    path = str(tmp_path / f"a.{source}")
    (write_petsc_binary_matrix if source == "petsc" else write_matrix_market)(path, a)
    flags = [f"--{source}", path, "--svd", "20", "-k", "2"]
    port, ref = _run(pt_eig.main, ref_eig, "demo_eig", flags, capsys, monkeypatch)
    for (_, nums), (_, rnums) in zip(port[1:], ref[1:]):
        assert _close(nums[1], rnums[1], 1e-12)


@pytest.mark.parametrize("flags,rtol", [
    (["--lap2d", "40"], 1e-12),
    (["--lap2d", "40", "--dia", "--devices", "2"], 1e-12),
    (["--lap2d", "40", "--dia", "--symmetric", "--fp32"], 1e-4),
    (["--lap2d", "40", "--format", "auto"], 1e-11),
    (["--lap2d", "40", "--format", "well", "--fp32"], 1e-4),
    (["--lap2d", "40", "--format", "well_ds", "--symmetric", "--devices", "2"], 1e-11),
    (["--lap1d", "3000", "--format", "dia_ds", "--iters", "30"], 1e-11),
    (["--lap3d", "10", "--symmetric", "--devices", "4", "--iters", "20"], 1e-12),
])
def test_demo_spmv_matches_reference(flags, rtol, capsys, monkeypatch):
    port, ref = _run(pt_spmv.main, ref_spmv, "demo_spmv", flags, capsys, monkeypatch)
    assert port[-1][0] == "norm(y) = #" and _close(port[-1][1][0], ref[-1][1][0], rtol)
    assert port[-2][0] == ref[-2][0] == "SpMV: # ms/apply, # GFLOP/s"


def test_demo_spmv_reads_petsc_as_the_reference(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "a.petsc")
    write_petsc_binary_matrix(path, create_laplace_2d(30, 30))
    port, ref = _run(pt_spmv.main, ref_spmv, "demo_spmv", ["--petsc", path, "--dia"],
                     capsys, monkeypatch)
    assert _close(port[-1][1][0], ref[-1][1][0], 1e-12)


def test_demo_spmv_refuses_slices_and_cpu():
    with pytest.raises(NotImplementedError, match="two-tier"):
        pt_spmv.main(["--lap2d", "16", "--devices", "4", "--slices", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        pt_spmv.main(["--lap2d", "16", "--cpu"])
    with pytest.raises(SystemExit):
        pt_eig.main(["--lap2d", "16", "--cpu"])
