"""spmv_torch double-single arithmetic and the DS DIA / DS WELL formats vs
the spmv_tpu reference.

Seeded numpy inputs go through both packages. Tolerances:
- the DS primitives, the packers and the plain DS DIA apply equal the
  reference run op by op bit for bit (the same float32 operations in the
  same order);
- where XLA compiles the reference as one program (a Pallas kernel in
  interpret mode, a jitted apply), the hi planes are equal and the lo
  planes may differ, because XLA:CPU may contract ``ds_mul_f32``'s cross
  term ``ah*bl + al*bh`` into ``fma(ah, bl, al*bh)`` there
  (``test_well_ds_reference_contracts`` reproduces the reference's bits
  with that one fma), so the two agree to the DS rounding level: <= 4e-15
  relative L2 of hi + lo;
- against the host float64 CSR oracle: < 1e-13 relative L2, on values
  perturbed below float32 resolution so the lo planes carry information.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.ds as ref_ds
import spmv_tpu.gen as ref_gen
from spmv_tpu.ops import spmv_dia_ds_pallas as ref_dia_ds
from spmv_tpu.ops import spmv_well_pallas as ref_well

import spmv_torch.ds as pt_ds
import spmv_torch.gen as pt_gen
from spmv_torch import _build
from spmv_torch.ops import spmv_dia_ds_cuda, spmv_well_ds_cuda
from spmv_torch.ops.spmv_dia_ds import (
    csr_to_dia_ds,
    spmv_dia_ds,
    spmv_dia_ds_2d,
    spmv_dia_ds_stacked_plain,
)
from spmv_torch.ops.spmv_well_ds import (
    csr_to_well_ds,
    spmv_well_ds,
    spmv_well_ds_2d,
    spmv_well_ds_stacked_plain,
)

# hi + lo of the port vs the reference where XLA:CPU contracted a
# multiply-add the port rounds twice (module docstring)
CONTRACTION_TOL = 4e-15


def _assert_matches_compiled(got, want):
    """The port's (hi, lo) against a reference that XLA compiled as one
    program (module docstring)."""
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    g = pt_ds.ds_to_f64(got[0].numpy(), got[1].numpy())
    w = ref_ds.ds_to_f64(want[0], want[1])
    assert np.linalg.norm(g - w) <= CONTRACTION_TOL * np.linalg.norm(w)


def _operands(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    w = rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))
    return (*pt_ds.ds_from_f64(v), *pt_ds.ds_from_f64(w))


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "split", "two_prod",
                                  "ds_add", "ds_mul_f32"])
def test_primitives_bit_equal_to_reference(name):
    ah, al, bh, bl = _operands()
    if name == "fast_two_sum":
        # its precondition |a| >= |b|
        ah, bh = np.maximum(np.abs(ah), np.abs(bh)), np.minimum(np.abs(ah), np.abs(bh))
    args = {"split": (ah,), "two_sum": (ah, bh), "fast_two_sum": (ah, bh),
            "two_prod": (ah, bh)}.get(name, (ah, al, bh, bl))
    want = getattr(ref_ds, name)(*map(jnp.asarray, args))
    got = getattr(pt_ds, name)(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_host_conversions_match_reference():
    v = np.random.default_rng(1).standard_normal(1000) * 1e5
    for g, w in zip(pt_ds.ds_from_f64(v), ref_ds.ds_from_f64(v)):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    assert np.array_equal(pt_ds.ds_to_f64(*pt_ds.ds_from_f64(v)),
                          ref_ds.ds_to_f64(*ref_ds.ds_from_f64(v)))


def test_two_prod_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = pt_ds.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.numpy().astype(np.float64)
                                  + e.numpy().astype(np.float64), exact)


def test_ds_roundtrip_and_arithmetic():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(1000) * np.exp(rng.uniform(-20, 20, 1000))
    hi, lo = pt_ds.ds_from_f64(v)
    np.testing.assert_allclose(pt_ds.ds_to_f64(hi, lo), v, rtol=2e-15)
    w = rng.standard_normal(1000)
    whi, wlo = pt_ds.ds_from_f64(w)
    t = [torch.from_numpy(u) for u in (hi, lo, whi, wlo)]
    sh, sl = pt_ds.ds_add(*t)
    np.testing.assert_allclose(pt_ds.ds_to_f64(sh.numpy(), sl.numpy()), v + w,
                               rtol=1e-13)
    ph, plo = pt_ds.ds_mul_f32(*t)
    np.testing.assert_allclose(pt_ds.ds_to_f64(ph.numpy(), plo.numpy()), v * w,
                               rtol=1e-13)


# ----------------------------------------------------------------- DS DIA


def _perturbed(ref, pt, seed):
    """The same values perturbed below float32 resolution in both."""
    rng = np.random.default_rng(seed)
    ref.values[:] = ref.values * (1 + 1e-9 * rng.standard_normal(ref.nnz))
    pt.values[:] = ref.values
    return ref, pt, rng


def _dia_pair(gen, seed=2):
    if gen == "lap2d":
        pair = ref_gen.create_laplace_2d(40, 33), pt_gen.create_laplace_2d(40, 33)
    else:
        pair = (ref_gen.create_laplace_1d(5000, gamma=0.37),
                pt_gen.create_laplace_1d(5000, gamma=0.37))
    return _perturbed(*pair, seed)


def _lanes(v):
    hi, lo = pt_ds.ds_from_f64(v)
    return hi.reshape(-1, 128), lo.reshape(-1, 128)


@pytest.mark.parametrize("gen", ["lap2d", "lap1d"])
def test_csr_to_dia_ds_matches_reference(gen):
    ref, pt, _ = _dia_pair(gen)
    r = ref_dia_ds.csr_to_dia_ds(ref, row_align=1024)
    p = csr_to_dia_ds(pt, row_align=1024, device="cpu")
    assert p.offsets == r.offsets and (p.nrows, p.ncols) == (r.nrows, r.ncols)
    for name in ("data_hi", "data_lo"):
        got = getattr(p, name)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(getattr(r, name)))
    assert p.format_size_bytes() == r.format_size_bytes()
    assert np.any(p.data_lo.numpy() != 0)


@pytest.mark.parametrize("variant", ["xla", "xla_jit", "pallas_interpret"])
@pytest.mark.parametrize("gen", ["lap2d", "lap1d"])
def test_plain_dia_ds_matches_reference(gen, variant):
    ref, pt, rng = _dia_pair(gen)
    r = ref_dia_ds.csr_to_dia_ds(ref, row_align=1024)
    p = csr_to_dia_ds(pt, row_align=1024, device="cpu")
    x = np.zeros(p.nrows_pad)
    x[: ref.nrows] = rng.standard_normal(ref.nrows) * 1e3
    xh2, xl2 = _lanes(x)
    fn = {"xla": ref_dia_ds.spmv_dia_ds_xla,
          "xla_jit": jax.jit(ref_dia_ds.spmv_dia_ds_xla),
          "pallas_interpret": lambda *a: ref_dia_ds.spmv_dia_ds_pallas_2d(
              *a, interpret=True)}[variant]
    want = fn(r, jnp.asarray(xh2), jnp.asarray(xl2))
    got = spmv_dia_ds_2d(p, torch.from_numpy(xh2), torch.from_numpy(xl2))
    if variant == "xla":  # op by op: the same operations, the same bits
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    else:  # compiled: XLA:CPU contracts on lap1d, not on lap2d
        _assert_matches_compiled(got, want)


@pytest.mark.parametrize("gen", ["lap2d", "lap1d"])
def test_dia_ds_f64_class(gen):
    ref, pt, rng = _dia_pair(gen)
    d = csr_to_dia_ds(pt, row_align=1024, device="cpu")
    x = rng.standard_normal(pt.nrows) * 1e3
    y = spmv_dia_ds(d, x)[: pt.nrows]
    want = pt.matvec(x)
    err = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert err < 1e-13, err
    # the reference's convenience function (a compiled Pallas kernel)
    yr = ref_dia_ds.spmv_dia_ds(ref_dia_ds.csr_to_dia_ds(ref, row_align=1024),
                                x, interpret=True)[: pt.nrows]
    assert np.linalg.norm(y - yr) <= CONTRACTION_TOL * np.linalg.norm(yr)
    # a float32-storage path cannot see the 1e-9 value perturbations at all
    f32_err = np.linalg.norm(
        pt.matvec(x.astype(np.float32).astype(np.float64)).astype(np.float32)
        .astype(np.float64) - want) / np.linalg.norm(want)
    assert err < f32_err / 10


def test_stacked_dia_ds_shards_read_only_their_own_x():
    """D=3 stacked shards, odd offsets: each shard equals the reference's
    single-block apply of its own data, x zero outside the shard."""
    rng = np.random.default_rng(3)
    offs = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    nd, nr = 3, 24
    dh = rng.standard_normal((nd, nr, len(offs) * 128)).astype(np.float32)
    dl = (dh * 1e-8 * rng.standard_normal(dh.shape)).astype(np.float32)
    xh = rng.standard_normal((nd * nr, 128)).astype(np.float32)
    xl = (xh * 1e-8 * rng.standard_normal(xh.shape)).astype(np.float32)
    yh, yl = spmv_dia_ds_stacked_plain(*map(torch.from_numpy, (dh, dl, xh, xl)), offs)
    for s in range(nd):
        m = ref_dia_ds.DiaDsMatrix(data_hi=jnp.asarray(dh[s]), data_lo=jnp.asarray(dl[s]),
                                   offsets=offs, nrows=nr * 128, ncols=nr * 128)
        rows = slice(s * nr, (s + 1) * nr)
        wh, wl = ref_dia_ds.spmv_dia_ds_xla(m, jnp.asarray(xh[rows]), jnp.asarray(xl[rows]))
        assert np.array_equal(yh[rows].numpy(), np.asarray(wh))
        assert np.array_equal(yl[rows].numpy(), np.asarray(wl))


# ---------------------------------------------------------------- DS WELL

# (tile_groups, pair): int32 pos below 16-aligned tiles, int16 at 16
WELL_CASES = [(2, False), (16, False), (16, True), (8, True)]


def _well_pair(seed=1):
    ref = ref_gen.random_csr(600, 600, 6, seed=seed)
    pt = pt_gen.random_csr(600, 600, 6, seed=seed)
    ref.values[:] = ref.values * (1 + 1e-10 * np.random.default_rng(0).standard_normal(ref.nnz))
    pt.values[:] = ref.values
    return ref, pt


def _well_both(tg, pair):
    ref, pt = _well_pair()
    return (ref, pt, ref_well.csr_to_well_ds(ref, tile_groups=tg, pair=pair),
            csr_to_well_ds(pt, tile_groups=tg, pair=pair, device="cpu"))


@pytest.mark.parametrize("tg,pair", WELL_CASES)
def test_csr_to_well_ds_matches_reference(tg, pair):
    _, _, r, p = _well_both(tg, pair)
    for name in ("values_hi", "values_lo", "pos", "w0"):
        got, want = getattr(p, name), np.asarray(getattr(r, name))
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), name
    assert (p.wseg, p.nseg, p.paired, p._nnz) == (r.wseg, r.nseg, r.paired, r._nnz)
    assert p.pos.dtype == (torch.int16 if tg == 16 else torch.int32)
    assert p.paired == pair


def _well_x(p, seed=4):
    x = np.zeros(p.ncols_pad)
    x[:600] = np.random.default_rng(seed).standard_normal(600) * 1e2
    return x


@pytest.mark.parametrize("tg,pair", WELL_CASES)
def test_plain_well_ds_matches_reference_kernel(tg, pair):
    _, _, r, p = _well_both(tg, pair)
    xh2, xl2 = _lanes(_well_x(p))
    want = ref_well.spmv_well_ds_pallas_2d(r, jnp.asarray(xh2), jnp.asarray(xl2),
                                           interpret=True)
    got = spmv_well_ds_2d(p, torch.from_numpy(xh2), torch.from_numpy(xl2))
    _assert_matches_compiled(got, want)


def _mul_contracted(ah, al, bh, bl):
    """ds_mul_f32 with the cross term as XLA:CPU compiles it: one fma,
    fma(ah, bl, al*bh), emulated in float64 (the product is exact there)."""
    ph, pe = pt_ds.two_prod(ah, bh)
    cross = (ah.double() * bl.double() + (al * bh).double()).float()
    return pt_ds.fast_two_sum(ph, pe + cross)


@pytest.mark.parametrize("tg,pair", WELL_CASES[:2])
def test_well_ds_reference_contracts(tg, pair, monkeypatch):
    """The one difference from the reference kernel is the fma XLA:CPU puts
    into ds_mul_f32's cross term: with it, the plain version reproduces
    both of the reference's planes bit for bit."""
    import spmv_torch.ops.spmv_well_ds as mod

    _, _, r, p = _well_both(tg, pair)
    xh2, xl2 = _lanes(_well_x(p))
    want = ref_well.spmv_well_ds_pallas_2d(r, jnp.asarray(xh2), jnp.asarray(xl2),
                                           interpret=True)
    monkeypatch.setattr(mod, "ds_mul_f32", _mul_contracted)
    got = spmv_well_ds_2d(p, torch.from_numpy(xh2), torch.from_numpy(xl2))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_well_ds_f64_class():
    ref, pt = _well_pair()
    w = csr_to_well_ds(pt, tile_groups=2, device="cpu")
    x = np.random.default_rng(0).standard_normal(pt.ncols) * 1e2
    y = spmv_well_ds(w, x)[: pt.nrows]
    want = pt.matvec(x)
    err = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert err < 1e-13, err
    yr = ref_well.spmv_well_ds(ref_well.csr_to_well_ds(ref, tile_groups=2), x,
                               interpret=True)[: pt.nrows]
    assert np.linalg.norm(y - yr) <= CONTRACTION_TOL * np.linalg.norm(yr)


# ----------------------------------------------------------- the wrappers


def test_wrappers_take_plain_path_on_cpu():
    _build.launches.clear()
    _, pt, rng = _dia_pair("lap2d")
    d = csr_to_dia_ds(pt, row_align=1024, device="cpu")
    xh2, xl2 = map(torch.from_numpy, _lanes(rng.standard_normal(d.nrows_pad)))
    got = spmv_dia_ds_2d(d, xh2, xl2)
    want = spmv_dia_ds_stacked_plain(d.data_hi.unsqueeze(0), d.data_lo.unsqueeze(0),
                                     xh2, xl2, d.offsets)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _, _, _, w = _well_both(16, True)
    xh2, xl2 = map(torch.from_numpy, _lanes(_well_x(w)))
    got = spmv_well_ds_2d(w, xh2, xl2)
    want = spmv_well_ds_stacked_plain(
        w.values_hi.unsqueeze(0), w.values_lo.unsqueeze(0), w.pos.unsqueeze(0),
        w.w0.unsqueeze(0), xh2, xl2, w.tile_groups)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert _build.launches["dia_ds"] == _build.launches["dia_ds_spmm"] == 0
    assert _build.launches["well_ds"] == 0


def _dia_inputs():
    offs = (-1, 0, 1)
    return ([torch.zeros((2, 4, 3 * 128)), torch.zeros((2, 4, 3 * 128)),
             torch.zeros((8, 128)), torch.zeros((8, 128))], offs)


@pytest.mark.parametrize("case,exc", [
    ("f64", TypeError), ("no_diags", ValueError), ("too_many_diags", ValueError),
    ("lo_shape", ValueError), ("x_shape", ValueError), ("noncontiguous", ValueError),
])
def test_dia_ds_wrapper_rejects_bad_input(case, exc):
    t, offs = _dia_inputs()
    if case == "f64":
        t[2] = t[2].double()
    elif case == "no_diags":
        offs = ()
    elif case == "too_many_diags":
        offs = tuple(range(65))
        t[0] = t[1] = torch.zeros((2, 4, 65 * 128))
    elif case == "lo_shape":
        t[1] = t[1][:, :, :256]
    elif case == "x_shape":
        t[3] = t[3][:-1]
    elif case == "noncontiguous":
        t[2] = torch.zeros((128, 8)).t()
    with pytest.raises(exc):
        spmv_dia_ds_cuda.spmv_dia_ds_stacked(*t, offs)


@pytest.mark.parametrize("case,exc", [
    ("f64", TypeError), ("pos_dtype", TypeError), ("w0_dtype", TypeError),
    ("lo_shape", ValueError), ("groups", ValueError), ("w0_shape", ValueError),
    ("x_shape", ValueError), ("ptr_dtype", TypeError), ("ptr_length", ValueError),
])
def test_well_ds_wrapper_rejects_bad_input(case, exc):
    """The row-list operands: values hi/lo and pos (D, E), slice_ptr
    (D, 4G + 1), w0 (D, G/tg)."""
    nd, e, g, tg = 2, 96, 8, 4
    vh, vl = torch.zeros((nd, e)), torch.zeros((nd, e))
    pos = torch.zeros((nd, e), dtype=torch.int32)
    ptr = torch.zeros((nd, 4 * g + 1), dtype=torch.int64)
    w0 = torch.zeros((nd, g // tg), dtype=torch.int32)
    xh, xl = torch.zeros((nd * g, 128)), torch.zeros((nd * g, 128))
    if case == "f64":
        vl = vl.double()
    elif case == "pos_dtype":
        pos = pos.long()
    elif case == "w0_dtype":
        w0 = w0.long()
    elif case == "lo_shape":
        vl = vl[:, :64].contiguous()
    elif case == "groups":
        tg = 3
    elif case == "w0_shape":
        w0 = w0[:, :1].contiguous()
    elif case == "x_shape":
        xl = xl[:-1]
    elif case == "ptr_dtype":
        ptr = ptr.int()
    elif case == "ptr_length":
        ptr = ptr[:, :-2].contiguous()
    with pytest.raises(exc):
        spmv_well_ds_cuda.spmv_well_ds_stacked(vh, vl, pos, ptr, w0, xh, xl, tg)
    assert _build.launches["well_ds"] == 0
