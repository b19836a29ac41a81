"""The stream kernel of ``dia_sym_spmv`` (``csrc/dia_stream.cu``) and the
route that sends an apply to it.

``spmv_dia_cuda.stream_plan`` lays out, once per (offsets, dtype), the
sliding windows the kernel keeps in shared memory (one of x a cluster of
read offsets, the forward rows of all diagonals, the transposed rows of each
far cluster's diagonals) and writes them as the int32 words the kernel takes
by value. The kernel cannot run here, so these tests hold the plan:

- through a torch model of the kernel that follows the words as the CUDA
  code reads them: runs of blocks one after another on one CTA (its shared
  memory never cleared between runs), each window's blocks copied as the
  producer copies them with the producer as far ahead as the barriers let
  it (``depth`` steps), a block outside the shard copied from zeros, and
  every read of every row through the consumer's slot arithmetic. Each
  read is checked against a tag of the element it should find (so a read
  of an unwritten, overwritten or wrong element fails), and the sums are
  bit for bit the plain version's on D = 2 stacked shards;
- each block of each window copied exactly once a run, and the rings in
  227 KB in every dtype;
- ``route``: which applies it sends to the stream kernel (HPCG's operator
  where the tile kernel's plan misses its shared-memory target) and which
  keep their route, and the C entry ``entry`` names for it.

On the card (the ``cuda`` marker; this file imports no jax, so run it there
with ``python -m pytest tests/test_torch_dia_stream.py -m cuda
--noconftest``): the kernel against the tile kernel bit for bit and against
the plain version, and one HPCG set's launches.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from spmv_torch import _build
from spmv_torch.ops import spmv_dia_cuda
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain
from spmv_torch.ops.spmv_dia_cuda import (
    SMEM_MAX,
    STREAM_DIAG_WORDS,
    STREAM_HEAD,
    STREAM_MAX_K,
    STREAM_MAX_WIN,
    STREAM_WIN_WORDS,
    Route,
    stream_plan,
)

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def hpcg(nx, ny, nz):
    """The stored (lower) offsets of HPCG's 27-point operator."""
    return tuple(sorted(o for o in {sx + nx * (sy + ny * sz) for sz in (-1, 0, 1)
                                    for sy in (-1, 0, 1) for sx in (-1, 0, 1)} if o <= 0))


def seven_point(nx, ny, nz):
    """The stored (lower) offsets of a 7-point 3-D Laplacian."""
    return (-nx * ny, -nx, -1, 0)


def dtype_id(d):
    return str(d).split(".")[1]


class Words:
    """The plan's words, decoded as csrc/dia_stream.cu's Plan lays them out."""

    def __init__(self, plan):
        w = list(plan.words)
        assert len(w) == STREAM_HEAD + STREAM_WIN_WORDS * STREAM_MAX_WIN + \
            STREAM_DIAG_WORDS * STREAM_MAX_K
        (self.K, self.nx, self.nwin, self.ns_f, self.ns_o, self.depth, self.span,
         self.smem) = w[:8]
        self.itemsize = plan.itemsize
        at = STREAM_HEAD
        for name in ("w_k0", "w_nk", "w_lo", "w_width", "w_ns", "w_base"):
            setattr(self, name, w[at: at + STREAM_MAX_WIN])
            at += STREAM_MAX_WIN
        for name in ("xf_rel", "xf_base", "xt_rel", "xt_base", "dt_far", "dt_rel",
                     "dt_base", "dt_stride"):
            setattr(self, name, w[at: at + STREAM_MAX_K])
            at += STREAM_MAX_K


UNWRITTEN = -(2 ** 62)


def model(plan, data, x2, run):
    """The stream kernel on the CPU, driven by the plan's words: returns (y2,
    copies), copies the (shard, first block of the run, window, block) of
    every bulk copy. Every read is checked against the tag of the element it
    should find: x row j of the shard j + 1 (0 outside [0, npad)); row j of
    diagonal k -(its flat index in the shard's data + 1) (0 past npad).
    Accumulates in float64 for float64 and in float32 otherwise (bf16
    rounded once, at the end), one multiply and one add a term, as the plain
    version does."""
    p = Words(plan)
    nd, nr = data.shape[0], data.shape[1]
    K = p.K
    npad, nblocks = nr * 128, nr
    acc_t = torch.float64 if data.dtype == torch.float64 else torch.float32
    size = p.smem // data.element_size()
    xs = x2.view(nd, npad).to(acc_t)
    ds = data.view(nd, nr, K * 128).to(acc_t)
    rows = torch.arange(npad)
    x_tag = rows + 1
    d_tag = -(torch.arange(nr * K * 128).view(nr, K * 128) + 1)
    vals = torch.full((size,), float("nan"), dtype=acc_t)
    tags = torch.full((size,), UNWRITTEN, dtype=torch.int64)
    y = torch.full((nd, npad), float("nan"), dtype=acc_t)
    copies = []
    lane = torch.arange(128)
    m_o = p.ns_o * 128
    f_base = p.w_base[p.nx]

    def read(idx):
        assert int(idx.min()) >= 0 and int(idx.max()) < size, "read outside shared memory"
        return vals[idx], tags[idx]

    def want_x(j):
        return torch.where((j >= 0) & (j < npad), j + 1, torch.zeros_like(j))

    def want_d(j, k):
        ok = j < npad
        jj = torch.where(ok, j, torch.zeros_like(j))
        return torch.where(ok, -((jj // 128) * K * 128 + k * 128 + jj % 128 + 1),
                           torch.zeros_like(j))

    runs_per_shard = -(-nblocks // run)
    for s in range(nd):
        for ri in range(runs_per_shard):
            q0 = ri * run
            steps = min(run, nblocks - q0)

            def issue(t):
                for w in range(p.nwin):
                    width, ns, nk = p.w_width[w], p.w_ns[w], p.w_nk[w]
                    for d in (range(width) if t == 0 else (width - 1,)):
                        b = q0 + t + p.w_lo[w] + d
                        dst = p.w_base[w] + ((t + d) % ns) * nk * 128
                        n = nk * 128
                        assert 0 <= dst and dst + n <= size
                        if 0 <= b < nblocks:
                            if w < p.nx:
                                v, g = xs[s, b * 128: (b + 1) * 128], x_tag[b * 128: (b + 1) * 128]
                            else:
                                k0 = p.w_k0[w]
                                v = ds[s, b, k0 * 128: (k0 + nk) * 128]
                                g = d_tag[b, k0 * 128: (k0 + nk) * 128]
                        else:
                            v, g = torch.zeros(n, dtype=acc_t), torch.zeros(n, dtype=torch.int64)
                        vals[dst: dst + n] = v
                        tags[dst: dst + n] = g
                        copies.append((s, q0, w, b))

            issued = -1
            s_f = s_o = 0
            for t in range(steps):
                # the producer as far ahead as its barriers let it: step
                # t + depth once every step before t is summed
                while issued < min(t + p.depth, steps - 1):
                    issued += 1
                    issue(issued)
                i = (q0 + t) * 128 + lane
                f = f_base + s_f * K * 128 + lane
                tl = s_o * 128 + lane
                acc = torch.zeros(128, dtype=acc_t)
                for k, o in enumerate(plan.offsets):
                    e = tl + p.xf_rel[k]
                    e = torch.where(e >= m_o, e - m_o, e)
                    xv, xg = read(p.xf_base[k] + e)
                    dv, dg = read(f + k * 128)
                    assert torch.equal(xg, want_x(i + o)), (t, k, "forward x")
                    assert torch.equal(dg, want_d(i, k)), (t, k, "forward data")
                    acc = acc + dv * xv
                    assert (p.xt_base[k] >= 0) == (o < 0)
                    if o < 0:
                        et = tl + p.xt_rel[k]
                        et = torch.where(et >= m_o, et - m_o, et)
                        xv, xg = read(p.xt_base[k] + et)
                        u = lane + p.dt_rel[k]
                        ns = p.ns_o if p.dt_far[k] else p.ns_f
                        slot = (s_o if p.dt_far[k] else s_f) + (u >> 7)
                        slot = torch.where(slot >= ns, slot - ns, slot)
                        dv, dg = read(p.dt_base[k] + slot * p.dt_stride[k] + (u & 127))
                        assert torch.equal(xg, want_x(i - o)), (t, k, "transposed x")
                        assert torch.equal(dg, want_d(i - o, k)), (t, k, "transposed data")
                        acc = acc + dv * xv
                y[s, (q0 + t) * 128 + lane] = acc
                s_f = (s_f + 1) % p.ns_f
                s_o = (s_o + 1) % p.ns_o
    return y.view(nd * nr, 128).to(x2.dtype), copies


def inputs(offsets, nrows, dtype, seed):
    """Random data and x on D = 2 shards of npad = 128 * ceil(nrows / 128)
    rows (the data past the grid random too: both designs read it alike)."""
    rng = np.random.default_rng(seed)
    nr = -(-nrows // 128)
    data = torch.as_tensor(rng.standard_normal((2, nr, len(offsets) * 128))).to(dtype)
    x2 = torch.as_tensor(rng.standard_normal((2 * nr, 128))).to(dtype)
    return data, x2


# grids small enough for the model, each a multi-plane plan: planes of 960
# rows (7.5 blocks: lines and planes that are not multiples of 128), of 1024
# (32^3) and a 7-point operator on planes of 480 rows
MODEL_GRIDS = {"hpcg 40x24x6": (hpcg(40, 24, 6), 40 * 24 * 6),
               "hpcg 32^3": (hpcg(32, 32, 32), 32 ** 3),
               "7-point 24x20x9": (seven_point(24, 20, 9), 24 * 20 * 9)}


@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
@pytest.mark.parametrize("name", list(MODEL_GRIDS))
def test_model_of_kernel_equals_plain(name, dtype):
    """Every read of every row finds its element (tags), and the model's
    sums are the plain version's bit for bit, at the plan's span and at a
    run of 5 blocks (runs start and end off the planes)."""
    offsets, n = MODEL_GRIDS[name]
    plan = stream_plan(offsets, dtype)
    assert plan is not None and len(plan.x_windows) >= 2
    data, x2 = inputs(offsets, n, dtype, len(offsets) + plan.span)
    want = spmv_dia_stacked_plain(data, x2, offsets, True)
    for run in sorted({plan.span, 5}):
        got, _ = model(plan, data, x2, run)
        assert torch.equal(got, want), run


@pytest.mark.parametrize("run", [1, 3, 8, 64])
def test_model_at_any_run_length(run):
    """The windows refill at every run's first step whatever the run's
    length, down to one block a run, with the rings left dirty by the run
    before (fp64, planes of 960 rows)."""
    offsets, n = MODEL_GRIDS["hpcg 40x24x6"]
    plan = stream_plan(offsets, torch.float64)
    data, x2 = inputs(offsets, n, torch.float64, run)
    got, _ = model(plan, data, x2, run)
    assert torch.equal(got, spmv_dia_stacked_plain(data, x2, offsets, True))


@pytest.mark.parametrize("name", list(MODEL_GRIDS))
def test_each_block_of_each_window_copied_once_a_run(name):
    """A run of steps [q0, q0 + steps) copies window w's blocks
    [q0 + lo, q0 + steps - 1 + hi], each exactly once: 1 block a window a
    step after the first, none twice."""
    offsets, n = MODEL_GRIDS[name]
    plan = stream_plan(offsets, torch.float64)
    p = Words(plan)
    data, x2 = inputs(offsets, n, torch.float64, 3)
    run = plan.span
    _, copies = model(plan, data, x2, run)
    nblocks = data.shape[1]
    by = {}
    for s, q0, w, b in copies:
        by.setdefault((s, q0, w), []).append(b)
    for s in range(2):
        for q0 in range(0, nblocks, run):
            steps = min(run, nblocks - q0)
            for w in range(p.nwin):
                lo = p.w_lo[w]
                want = list(range(q0 + lo, q0 + steps - 1 + lo + p.w_width[w]))
                assert by[s, q0, w] == want
    per_step = len(copies) / (2 * nblocks)
    assert per_step >= p.nwin


class Barrier:
    """An mbarrier: ``count`` arrivals and the expected bytes end a phase;
    ``done`` counts the phases ended. A wait on parity P passes once the
    current (unfinished) phase's parity differs from P: so a waiter whose
    phase has ended and whose barrier has since moved two phases on sees
    its own parity again and waits, as on the card."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.done = count, count, 0, 0

    def _maybe_end(self):
        if self.pending == 0 and self.tx == 0:
            self.done += 1
            self.pending = self.count

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        assert self.pending >= 0
        self._maybe_end()

    def complete_tx(self, n):
        self.tx -= n
        self._maybe_end()

    def passes(self, parity):
        return (self.done & 1) != parity


def kernel_groups(itemsize: int) -> int:
    """The consumer groups csrc/dia_stream.cu runs for this storage size
    (kGroupsWide for fp64, kGroupsNarrow otherwise)."""
    import re
    from pathlib import Path

    src = (Path(spmv_dia_cuda.__file__).parent.parent / "csrc" / "dia_stream.cu").read_text()
    name = "kGroupsWide" if itemsize == 8 else "kGroupsNarrow"
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def run_protocol(p, runs, seed, groups=None, nbars=None):
    """The kernel's barrier protocol on one CTA, as csrc/dia_stream.cu runs
    it, under a random schedule: producer lanes (one a window) and consumer
    groups as processes that block on barrier waits, and each bulk copy
    landing at a random later moment (a slot in flight holds nothing).
    ``runs`` are the step counts of the CTA's runs. Returns "ok", or
    "deadlock"; a step that reads a slot not holding its block raises."""
    rng = np.random.default_rng(seed)
    groups = kernel_groups(p.itemsize) if groups is None else groups
    nbars = p.depth + groups if nbars is None else nbars
    full = [Barrier(1) for _ in range(nbars)]
    empty = [Barrier(128) for _ in range(nbars)]
    rings = [[None] * p.w_ns[w] for w in range(p.nwin)]
    landing = []  # (window, slot, block, barrier, bytes)
    n_of = [p.w_nk[w] for w in range(p.nwin)]
    first = sum(p.w_width[w] * n_of[w] for w in range(p.nwin))
    steady = sum(n_of)

    def producer(w):
        g = 0
        for ri, steps in enumerate(runs):
            q0 = 1000 * ri
            b, slot = q0 + p.w_lo[w], 0
            for t in range(steps):
                end = g - 1 if t == 0 else g - 1 - p.depth
                for st in range(max(g - 1 - p.depth, 0), end + 1):
                    yield empty[st % nbars], (st // nbars) & 1
                bar = full[g % nbars]
                if w == 0:
                    bar.arrive(tx=first if t == 0 else steady)
                for _ in range(p.w_width[w] if t == 0 else 1):
                    rings[w][slot] = None
                    landing.append((w, slot, b, bar, n_of[w]))
                    b += 1
                    slot = (slot + 1) % p.w_ns[w]
                g += 1

    def consumer(h):
        g = 0
        for ri, steps in enumerate(runs):
            q0 = 1000 * ri
            for t in range(steps):
                if g % groups == h:
                    for st in range(max(g - groups + 1, 0), g + 1):
                        yield full[st % nbars], (st // nbars) & 1
                    for w in range(p.nwin):
                        for d in range(p.w_width[w]):
                            got = rings[w][(t + d) % p.w_ns[w]]
                            assert got == q0 + t + p.w_lo[w] + d, (g, w, d, got)
                    yield None, None  # the sums take a while
                    for _ in range(128):
                        empty[g % nbars].arrive()
                g += 1

    procs = [producer(w) for w in range(p.nwin)] + [consumer(h) for h in range(groups)]
    waits = [(None, None)] * len(procs)
    live = list(range(len(procs)))
    while live:
        ready = [i for i in live if waits[i][0] is None or waits[i][0].passes(waits[i][1])]
        if not ready and not landing:
            return "deadlock"
        pick = int(rng.integers(len(ready) + len(landing)))
        if pick >= len(ready):
            w, slot, b, bar, n = landing.pop(pick - len(ready))
            rings[w][slot] = b
            bar.complete_tx(n)
            continue
        i = ready[pick]
        try:
            waits[i] = next(procs[i])
        except StopIteration:
            live.remove(i)
    return "ok"


@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
def test_barrier_protocol_never_deadlocks_or_reads_early(dtype):
    """Under 200 random schedules of copy landings and thread progress, on
    runs of 9, 1 and 6 steps (a run's first step waits for every step
    before it): every step finds each of its blocks landed in its slot, and
    the CTA ends."""
    p = Words(stream_plan(MODEL_GRIDS["hpcg 40x24x6"][0], dtype))
    for seed in range(200):
        assert run_protocol(p, [9, 1, 6], seed) == "ok", seed


def test_barrier_protocol_needs_depth_plus_groups_barriers():
    """The simulation finds the hang the card showed with 4 groups and
    depth + 1 barriers in fp64: a group waiting on a full barrier that has
    moved two phases on. With depth + groups barriers it does not."""
    p = Words(stream_plan(MODEL_GRIDS["hpcg 40x24x6"][0], torch.float64))
    hung = [run_protocol(p, [9, 1, 6], seed, groups=4, nbars=p.depth + 1)
            for seed in range(100)]
    assert "deadlock" in hung
    assert all(run_protocol(p, [9, 1, 6], seed, groups=4) == "ok" for seed in range(100))


GRIDS = {"256^3": (256, 256, 256), "128^3": (128, 128, 128), "64^3": (64, 64, 64),
         "96x80x72": (96, 80, 72), "32^3": (32, 32, 32)}


@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plan_fits_and_lays_out_hpcgs_planes(grid, dtype):
    """HPCG's offsets make three x windows (the plane below, this plane, the
    plane above), the forward window of all 14 diagonals and one far data
    window of the 9 diagonals whose transposed rows lie a plane above; the
    rings fit 227 KB in every dtype, with at least 2 steps of copies in
    flight; the span is the plane in blocks; the words hold the windows
    without overlap."""
    nx, ny, nz = GRIDS[grid]
    offsets = hpcg(nx, ny, nz)
    plan = stream_plan(offsets, dtype)
    assert plan is not None
    p = Words(plan)
    plane = nx * ny
    assert len(plan.x_windows) == 3 and p.nx == 3
    assert [k1 - k0 for k0, k1, _, _ in plan.data_windows] == [14, 9]
    assert plan.data_windows[1][:2] == (0, 9)
    assert all(-o >= plane - nx - 1 for o in offsets[:9])
    assert plan.span == round(plane / 128)
    assert 2 <= plan.depth <= 8 and p.depth == plan.depth
    item = torch.empty(0, dtype=dtype).element_size()
    sizes = [p.w_ns[w] * p.w_nk[w] * 128 for w in range(p.nwin)]
    assert plan.smem_bytes == p.smem == sum(sizes) * item <= SMEM_MAX
    spans = sorted((p.w_base[w], p.w_base[w] + sizes[w]) for w in range(p.nwin))
    assert spans[0][0] == 0
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    # every ring holds its window and `depth` steps ahead
    for w in range(p.nwin):
        assert p.w_ns[w] >= p.w_width[w] + p.depth


def test_plan_cached_and_refuses():
    """One object per key; None where the offsets do not span clusters (the
    planes of 16^3 touch) or the kernel cannot hold them (more than 16
    diagonals, offsets not ascending); positive offsets are refused as the
    tile plan refuses them."""
    offs = hpcg(64, 64, 64)
    assert stream_plan(offs, torch.float64) is stream_plan(tuple(offs), torch.float64)
    assert stream_plan(offs, torch.float64) is not stream_plan(offs, torch.float32)
    assert stream_plan(hpcg(16, 16, 16), torch.float64) is None
    assert stream_plan(tuple(range(-2800, 1, 200)), torch.float32) is None
    assert stream_plan(tuple(range(-32, 1)), torch.float64) is None
    assert stream_plan(offs[::-1], torch.float64) is None
    with pytest.raises(ValueError, match="offsets <= 0"):
        stream_plan((-1, 0, 1), torch.float64)


STREAM_KEYS = [
    # HPCG's operator where the tile kernel's plan misses SMEM_TARGET
    (hpcg(256, 256, 256), torch.float64), (hpcg(256, 256, 256), torch.float32),
    (hpcg(128, 128, 128), torch.float64), (hpcg(128, 128, 128), torch.float32),
    (hpcg(64, 64, 64), torch.float64), (hpcg(96, 80, 72), torch.float64),
    (hpcg(32, 32, 32), torch.float64),
]
TILE_KEYS = [
    # plans within SMEM_TARGET: the Laplacians of the benchmark and phase 3,
    # the 7-point 3-D Laplacian (its plan is 11 KB at R = 128 in fp64),
    # HPCG in bf16, and in fp32 below 128^3
    *(((-3200, -1, 0), dt) for dt in DTYPES),
    *(((-1024, -1, 0), dt) for dt in DTYPES),
    *((seven_point(256, 256, 256), dt) for dt in DTYPES),
    *((seven_point(64, 64, 64), dt) for dt in DTYPES),
    (hpcg(256, 256, 256), torch.bfloat16), (hpcg(64, 64, 64), torch.float32),
    (hpcg(64, 64, 64), torch.bfloat16), (hpcg(96, 80, 72), torch.float32),
    # one cluster: the planes of 16^3 touch; the wide bands of AMG's 1-D
    # levels (K = 33 and 149 stored); a spread past shared memory; an AMG
    # level's symmetric half
    (hpcg(16, 16, 16), torch.float64),
    (tuple(range(-32, 1)), torch.float32), (tuple(range(-148, 1)), torch.float64),
    (tuple(range(-2800, 1, 200)), torch.float64),
    ((-801, -800, -799, -1, 0), torch.float32),
]


@pytest.mark.parametrize("offsets,dtype", STREAM_KEYS,
                         ids=lambda v: str(v).replace("torch.", "")[:40])
def test_route_sends_plane_spanning_offsets_to_the_stream_kernel(offsets, dtype):
    """dia_sym_spmv runs the stream kernel where the tile kernel's plan
    misses SMEM_TARGET at every R and the read offsets form at least two
    clusters; the C entry exists with as many arguments as it is bound
    with, and launches count under their own key."""
    from spmv_torch._build import KERNEL_ENTRIES

    r = spmv_dia_cuda.route(offsets, True, False, dtype)
    assert r == Route("stream")
    assert spmv_dia_cuda.window_plan(offsets, True, 1, dtype).smem_bytes > \
        spmv_dia_cuda.SMEM_TARGET
    name, args, kept = spmv_dia_cuda.entry(r, offsets, True, False, 1, dtype,
                                           torch.device("cpu"))
    assert name == f"dia_sym_spmv_stream_{spmv_dia_cuda.DTYPES[dtype]}"
    assert len(KERNEL_ENTRIES[name]) == len(args) + 7
    words, zeros = kept
    assert list(words) == list(stream_plan(offsets, dtype).words)
    assert zeros.numel() >= len(offsets) * 128 and not torch.any(zeros)
    assert spmv_dia_cuda.STREAM_KEY not in spmv_dia_cuda.KEYS.values()


@pytest.mark.parametrize("offsets,dtype", TILE_KEYS,
                         ids=lambda v: str(v).replace("torch.", "")[:40])
def test_route_keeps_the_tile_kernel_elsewhere(offsets, dtype):
    """Every other dia_sym_spmv apply keeps the tile kernel: its plan fits
    SMEM_TARGET, or its reads form one cluster."""
    assert spmv_dia_cuda.route(offsets, True, False, dtype) == Route("tile")


@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
def test_route_of_blocks_and_vanilla_storage_unchanged(dtype):
    """Vanilla applies and blocks of HPCG's operator keep their routes:
    dia_spmv's loop kernel (K = 27), the tile kernel for dia_spmm, the
    direct kernel for dia_sym_spmm."""
    lower = hpcg(256, 256, 256)
    full = tuple(sorted(set(lower) | {-o for o in lower}))
    assert spmv_dia_cuda.route(full, False, False, dtype) == Route("loop")
    assert spmv_dia_cuda.route(full, False, True, dtype) == Route("tile")
    assert spmv_dia_cuda.route(lower, True, True, dtype) == Route("loop")


def test_entry_refuses_offsets_the_stream_kernel_cannot_hold():
    with pytest.raises(ValueError, match="cannot hold"):
        spmv_dia_cuda.entry(Route("stream"), tuple(range(-32, 1)), True, False, 1,
                            torch.float64, torch.device("cpu"))
    with pytest.raises(ValueError, match="no DIA kernel runs route"):
        spmv_dia_cuda.entry(Route("stream"), hpcg(64, 64, 64), False, False, 1,
                            torch.float64, torch.device("cpu"))


# ---- on the card ---------------------------------------------------------

TOL = {torch.float32: 1e-6, torch.float64: 1e-13, torch.bfloat16: 8e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "tests/test_torch_dia_stream.py -m cuda --noconftest)")
    return torch.device("cuda")


CARD_CASES = {
    # (offsets, rows, shards)
    "hpcg 256^3": (hpcg(256, 256, 256), 256 ** 3, 1),
    "hpcg 64^3": (hpcg(64, 64, 64), 64 ** 3, 1),
    "hpcg 96x80x72": (hpcg(96, 80, 72), 96 * 80 * 72, 1),
    "hpcg 40x24x6 (planes of 7.5 blocks)": (hpcg(40, 24, 6), 40 * 24 * 6, 1),
    "hpcg 64^3 D=3": (hpcg(64, 64, 64), 64 ** 3, 3),
    "7-point 128^3": (seven_point(128, 128, 128), 128 ** 3, 1),
    "7-point 96x80x72 D=2": (seven_point(96, 80, 72), 96 * 80 * 72, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_stream_kernel_is_the_tile_kernel_bit_for_bit_on_cuda(cuda, case, dtype):
    """The stream kernel, launched through ``spmv_dia_cuda.launch``, gives
    the tile kernel's bits on the same inputs, the same bits again, and is
    within tolerance of the plain version (relative L2: 1e-6 fp32, 1e-13
    fp64, bf16's one ulp of contraction 8e-3); one launch under its key."""
    offsets, n, nd = CARD_CASES[case]
    nr = -(-n // 128)
    gen = torch.Generator(device=cuda).manual_seed(19)
    data = (torch.randn((nd, nr, len(offsets) * 128), generator=gen, device=cuda)
            / len(offsets)).to(dtype)
    x2 = torch.randn((nd * nr, 128), generator=gen, device=cuda).to(dtype)
    _build.launches.clear()
    y = spmv_dia_cuda.launch(Route("stream"), data, x2, offsets, True, False)
    tile = spmv_dia_cuda.launch(Route("tile"), data, x2, offsets, True, False)
    torch.cuda.synchronize()
    assert _build.launches[spmv_dia_cuda.STREAM_KEY] == 1
    assert _build.launches["dia_sym"] == 1
    assert torch.equal(y, tile)
    assert torch.equal(spmv_dia_cuda.launch(Route("stream"), data, x2, offsets, True,
                                            False), y)
    if n <= 128 ** 3:  # the plain version's temporaries at 256^3 fp64: ~4 GB
        want = spmv_dia_stacked_plain(data, x2, offsets, True)
        err = float(torch.linalg.vector_norm((y - want).double())
                    / torch.linalg.vector_norm(want.double()))
        assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_hpcg_set_launches_the_stream_kernel_on_cuda(cuda, monkeypatch):
    """One 50-iteration HPCG MG-PCG set at 32^3 in fp64 (the smallest grid
    of the benchmark's levels whose planes stand apart): 51 applies, each
    one launch under the stream kernel's key and none under dia_sym; the
    same set with the route held to the tile kernel launches 51 under
    dia_sym and gives the same bits."""
    from spmv_torch.gen import hpcg_27pt
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers import cg as cg_module
    from spmv_torch.solvers import gmg

    grid = (32, 32, 32)
    A = build_dist_matrix(hpcg_27pt(*grid), n_devices=1, symmetric=True,
                          dtype=np.float64, local_format="dia", device=cuda)
    mg = gmg.hpcg_hierarchy(A, grid, 4)
    b = A.to_dist(2.0 * np.random.default_rng(2 ** 31 + 19).random(A.nrows_global) - 1.0)
    assert spmv_dia_cuda.route(tuple(A.dia_offsets), True, False, torch.float64) == \
        Route("stream")
    got = {}
    for kernel in ("stream", "tile"):
        if kernel == "tile":
            monkeypatch.setattr(spmv_dia_cuda, "route", lambda *key: Route("tile"))
        _build.launches.clear()
        res = cg_module.cg(A.matvec, b, kmax=50, rtol=0.0,
                           preconditioner=mg.as_preconditioner())
        torch.cuda.synchronize()
        assert res.iterations == 50
        assert (_build.launches[spmv_dia_cuda.STREAM_KEY], _build.launches["dia_sym"]) == \
            ((51, 0) if kernel == "stream" else (0, 51))
        got[kernel] = res.x
    assert torch.equal(got["stream"], got["tile"])
