"""DOLFINx's Poisson demo operator (the benchmark's ``poisson2d_p1``
generator) against the plain reference of ``tests/poisson2d_reference.py``,
and the port's general-sparsity path on it: the symmetric float64 dual-WELL
apply at D = 1, 2, 4, and the ``layout_bytes`` record with its reader."""
from pathlib import Path

import numpy as np
import pytest
import torch

import poisson2d_reference as ref
from bench_h100 import harness, roofline
from bench_h100.matrices import poisson2d_p1
from bench_h100.reference import checks
from bench_h100.system import System
from spmv_torch.formats.csr import CSRHost
from spmv_torch.gen import create_laplace_2d
from spmv_torch.parallel import dist_matrix
from spmv_torch.parallel.dist_matrix import build_dist_matrix

ROOT = Path(__file__).resolve().parents[1]
CONFIG = {"reorder": None, "dtype": "float64", "storage": "symmetric",
          "local_format": "well", "solver": {"preconditioner": None}}
CPU = torch.device("cpu")


def _gen(cx, cy):
    return poisson2d_p1.generate({"cx": cx, "cy": cy})


def _dense(a):
    d = np.zeros((a.nrows, a.ncols))
    d[np.repeat(np.arange(a.nrows), np.diff(a.rowptr)), a.colind] = a.values
    return d


def _grid_rows(cx, cy):
    """new index -> (ix, iy) of each vertex, from the generator's order."""
    new = poisson2d_p1.level_order(cx, cy)
    ix, iy = np.meshgrid(np.arange(cx + 1), np.arange(cy + 1))
    out = np.empty((len(new), 2), dtype=np.int64)
    out[new] = np.stack([ix.ravel(), iy.ravel()], axis=1)
    return out


@pytest.mark.parametrize("cx,cy", [(8, 4), (24, 12)])
def test_generator_equals_the_reference_assembly(cx, cy):
    a = _gen(cx, cy)
    rowptr, colind, values = ref.assemble(cx, cy)
    np.testing.assert_array_equal(a.rowptr, rowptr)
    np.testing.assert_array_equal(a.colind, colind)   # the pattern, zeros stored
    np.testing.assert_array_equal(a.values, values)   # bit for bit
    nv = (cx + 1) * (cy + 1)
    edges = cx * (cy + 1) + (cx + 1) * cy + cx * cy
    assert a.nrows == nv and a.nnz == nv + 2 * edges
    assert a.lower_nnz() == nv + edges


@pytest.mark.parametrize("cx,cy", [(8, 4), (24, 12), (64, 32)])
def test_the_matrix_is_exactly_symmetric(cx, cy):
    d = _dense(_gen(cx, cy))
    np.testing.assert_array_equal(d, d.T)


@pytest.mark.parametrize("cx,cy", [(24, 12), (64, 32)])
def test_values_interior_and_dirichlet(cx, cy):
    a = _gen(cx, cy)
    xy = _grid_rows(cx, cy)
    rows = np.repeat(np.arange(a.nrows), np.diff(a.rowptr))
    dirichlet = np.isin(xy[:, 0], (0, cx))
    # away from the boundary and from the zeroed Dirichlet columns
    interior = ((xy[:, 0] > 1) & (xy[:, 0] < cx - 1) & (xy[:, 1] > 0)
                & (xy[:, 1] < cy))
    for r in np.flatnonzero(interior):
        v = a.values[a.rowptr[r]:a.rowptr[r + 1]]
        assert sorted(v.tolist()) == [-1.0] * 4 + [0.0, 0.0, 4.0]
        # the stored zeros are the right-diagonal couplings
        c = a.colind[a.rowptr[r]:a.rowptr[r + 1]][v == 0.0]
        assert sorted((xy[c] - xy[r]).tolist()) == [[-1, -1], [1, 1]]
    on_dirichlet_row = dirichlet[rows]
    on_dirichlet_col = dirichlet[a.colind]
    diag = rows == a.colind
    np.testing.assert_array_equal(a.values[on_dirichlet_row & diag], 1.0)
    np.testing.assert_array_equal(
        a.values[(on_dirichlet_row | on_dirichlet_col) & ~diag], 0.0)


def test_level_order_is_the_bfs_levels_and_leaves_no_dia():
    cx, cy = 64, 32
    a = _gen(cx, cy)
    xy = _grid_rows(cx, cy)
    level = xy[:, 0] + (cy - xy[:, 1])
    # reversed level order: new indices descend through the levels
    assert np.all(np.diff(level) <= 0)
    rows = np.repeat(np.arange(a.nrows), np.diff(a.rowptr))
    # every coupling joins the same or adjacent levels
    assert np.abs(level[rows] - level[a.colind]).max() == 1
    offsets = np.unique(a.colind.astype(np.int64) - rows)
    assert len(offsets) > dist_matrix.DIA_MAX_DIAGS


def _x(n, seed):
    return 2.0 * np.random.default_rng(seed).random(n) - 1.0


@pytest.mark.parametrize("nd", [1, 2, 4])
@pytest.mark.parametrize("cx,cy", [(64, 32), (96, 48)])
def test_port_dual_well_apply_against_the_reference(cx, cy, nd):
    a = _gen(cx, cy)
    host = CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    # the arguments System passes, at nd shards
    A = build_dist_matrix(host, n_devices=nd, symmetric=True, dtype=np.float64,
                          local_format="well", device=CPU)
    assert A.local_format == "well" and A.dtype == torch.float64
    tr = a.on(CPU)
    for seed in (2**31 + 7, 11):
        x = _x(a.nrows, seed)
        y = A.from_dist(A.matvec(A.to_dist(x)))
        assert checks.apply_error(tr, x, y) <= 1e-14
        want = ref.apply(a.rowptr, a.colind.astype(np.int64), a.values, x)
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-13)


def test_system_builds_the_dual_well_operator():
    a = _gen(64, 32)
    system = System(CONFIG, a, CPU)
    assert system.A.local_format == "well" and system.A.symmetric
    x = _x(a.nrows, 3)
    y = system.from_port(system.A.matvec(system.to_port(x)))
    assert checks.apply_error(a.on(CPU), x, y) <= 1e-14


def _nbytes(A, names):
    return sum(getattr(A, n).numel() * getattr(A, n).element_size() for n in names)


WELL_SYM = ["local_rows_values", "local_rows_pos", "local_rows_ptr",
            "local_well_w0", "local_rowsT_values", "local_rowsT_pos",
            "local_rowsT_ptr", "local_wellT_w0", "diagonal"]


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_layout_bytes_is_the_apply_arrays_and_the_vectors(nd):
    a = _gen(64, 32)
    host = CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    A = build_dist_matrix(host, n_devices=nd, symmetric=True, dtype=np.float64,
                          local_format="well", device=CPU)
    assert A.far_ell_colind is None and A.farT_ell_colind is None
    names = list(WELL_SYM)
    want = 8 * nd * (A.col_pad + A.row_pad)          # x once, y once
    if nd > 1:
        names += ["remote_colind", "remote_values", "remoteT_colind", "remoteT_vals"]
        want += sum(t.numel() * t.element_size()
                    for t in (A.plan.send_idx, A.plan.recv_pos))
    want += _nbytes(A, names)
    assert dist_matrix.layout_bytes == {"well": want}


def _lap(fmt, symmetric, dtype):
    return build_dist_matrix(create_laplace_2d(40, 40), symmetric=symmetric,
                             dtype=dtype, local_format=fmt, device=CPU)


@pytest.mark.parametrize("fmt,symmetric,dtype,names,itemsize", [
    ("ell", False, np.float32, ["local_colind", "local_values"], 4),
    ("ell", True, np.float64, ["local_colind", "local_values", "localT_colind",
                               "localT_values", "diagonal"], 8),
    ("dia", True, np.float64, ["local_dia_data"], 8),
    ("dia_ds", False, None, ["local_dia_data", "local_dia_data_lo"], 8),
    ("well", False, np.float32, WELL_SYM[:4], 4),
    ("well_ds", True, None, WELL_SYM + ["local_rows_values_lo",
                                        "local_rowsT_values_lo", "diagonal_lo"], 8),
])
def test_layout_bytes_is_set_for_every_format(fmt, symmetric, dtype, names, itemsize):
    A = _lap(fmt, symmetric, dtype)
    want = _nbytes(A, names) + itemsize * (A.col_pad + A.row_pad)
    assert dist_matrix.layout_bytes == {fmt: want}


def _reader():
    return harness.load_module(ROOT, "metrics", "layout_share")


def _run(a):
    return harness.Run(counters={}, host={}, trace=None,
                       roofline_s=roofline.apply_seconds(a, True, "float64"))


def test_layout_share_reads_the_record():
    a = _gen(64, 32)
    build_dist_matrix(CSRHost(a.rowptr, a.colind, a.values, a.ncols),
                      symmetric=True, dtype=np.float64, local_format="well",
                      device=CPU)
    share = _reader().read(_run(a))
    assert share == pytest.approx(100.0 * roofline.apply_bytes(a, True, "float64")
                                  / dist_matrix.layout_bytes["well"])
    assert 0 < share <= 100


@pytest.mark.parametrize("record", [None, {}])
def test_layout_share_is_none_without_the_record(monkeypatch, record):
    # the program before the record keeps none
    if record is None:
        monkeypatch.delattr(dist_matrix, "layout_bytes")
    else:
        monkeypatch.setattr(dist_matrix, "layout_bytes", record)
    assert _reader().read(_run(_gen(8, 4))) is None
