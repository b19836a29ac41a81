"""DIA SpMV wrappers over the CUDA kernels of ``csrc/spmv_dia.cu``.

Counterpart of ``spmv_tpu.ops.spmv_dia_pallas``: ``dia_spmv`` replaces
``_dia_kernel`` and ``dia_sym_spmv`` replaces ``_dia_sym_kernel``. Vectors
stay in the (rows, 128) lane layout, so repeated applies chain with no data
movement.

A CPU tensor takes the plain torch version (``ops/spmv_dia.py``); a CUDA
tensor launches the kernel or raises. ``_build.launches`` counts the
launches under "dia" and "dia_sym" (the block wrappers': "dia_spmm" and
"dia_sym_spmm"; dia_sym_spmv's stream kernel: "dia_sym_stream"), one per
call on a CUDA tensor.

The kernels take float32, float64 and bfloat16 storage (bf16 accumulates
in float32 and stores y in bf16) and any number of diagonals. ``route``
picks, once per (offsets, storage, block or not, dtype), the kernel an apply
launches: ``dia_spmv`` runs ``dia_spmv_rows`` (K at compile time, offsets
by value) at K = 5 and 9 and its loop kernel, which reads the offsets as an
int64 array on the card (``device_offsets``), at every other K.
``dia_sym_spmv`` and the block ``dia_spmm`` stage their reads in shared
memory, as ``window_plan`` lays them out: a table made once per (offsets,
symmetric, nrhs, dtype) and kept on the card (``device_window_plan``), so
an apply does no host work beyond the launch. ``dia_sym_spmv`` on offsets
that span planes runs the stream kernel instead (``stream_plan``: sliding
windows a cluster of offsets, its words passed by value).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from spmv_torch import _build
from spmv_torch.formats.dia import LANES, DiaMatrix
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain

DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# the launch counter's key of each (symmetric, block) apply
KEYS = {(False, False): "dia", (True, False): "dia_sym", (False, True): "dia_spmm",
        (True, True): "dia_sym_spmm"}
STREAM_KEY = "dia_sym_stream"  # dia_sym_spmv's launches of the stream kernel


@functools.lru_cache(maxsize=256)
def device_offsets(offsets: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The diagonal offsets as an int64 tensor on ``device``, which the
    kernels read; one copy per (offsets, device) is kept, so repeated
    applies make no host-to-device transfer."""
    return torch.tensor(offsets, dtype=torch.int64, device=device)


# The window plan of the tile kernel (csrc/dia_window.cuh). A CTA of 128
# threads computes a tile of R rows of one shard (and up to
# MAX_COLS columns of a block of right-hand sides). Before it sums, it
# copies into shared memory every x window the tile reads (the rows each
# read offset reaches: the stored offsets, and -o for each o < 0 in
# symmetric storage; merged into one window wherever they overlap, so
# offsets closer than R share one) and, stage by stage, the tile's rows of
# each diagonal; in symmetric storage a diagonal o < 0 also stages the
# rows [-o, R - o) its transpose term reads, one window with the forward
# rows where -o < R. Each window goes in bulk copies (the Tensor Memory
# Accelerator) of at most one 128-row tile row a column; where the
# diagonals go in several stages, two stage buffers alternate.
TILE_ROWS = (1024, 512, 256, 128)  # R, largest first; a thread takes R/128 rows
COPY_BYTES = 16                    # bulk copies are whole 16-byte units
SMEM_TARGET = 17 * 1024            # about eight CTAs an SM, each with its tile's
#                                    reads in flight (the fastest tile size on
#                                    the card, PERF.md)
SMEM_FIT = 48 * 1024               # failing that, four at R = 128
SMEM_MAX = 231424                  # the 227 KB a CTA may hold on the H100,
#                                    less 1 KB for its barriers
MAX_COLS = 8                       # columns a CTA holds (dia_spmm's chunks)
MIN_STAGE = 8                      # diagonals a stage holds, where K allows
# the kernel's table (int32 words): a head, then the x windows, the stages,
# the copies, one entry per diagonal and the x copies (csrc/dia_window.cuh
# reads it)
HEAD_WORDS, WIN_WORDS, STAGE_WORDS, COPY_WORDS, DIAG_WORDS, XCOPY_WORDS = 16, 4, 4, 4, 8, 4


def _floor(v: int, m: int) -> int:
    return v // m * m


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Where a tile of ``rows`` rows of the DIA tile kernel reads, in rows
    relative to the tile's first row. ``intervals`` are the rows of x the
    tile reads, rounded out to 16 bytes and merged; ``x_windows[w]`` is
    interval w where it is staged, or None where it does not fit in shared
    memory and the kernel reads that interval's x from global memory;
    ``data_windows[k]`` the rows of diagonal k staged; ``stages`` the
    diagonals [k0, k1) staged together (two stage buffers alternate when
    there are several); ``table`` the int32 words the kernel reads."""

    offsets: tuple[int, ...]
    symmetric: bool
    cols: int
    itemsize: int
    rows: int
    intervals: tuple[tuple[int, int], ...]
    x_windows: tuple[tuple[int, int] | None, ...]
    data_windows: tuple[tuple[tuple[int, int], ...], ...]
    stages: tuple[tuple[int, int], ...]
    smem_bytes: int
    table: tuple[int, ...]

    @property
    def global_intervals(self) -> tuple[int, ...]:
        """Indices of the intervals whose x is read from global memory."""
        return tuple(w for w, win in enumerate(self.x_windows) if win is None)

    def summary(self) -> dict:
        """What a run prints about the plan."""
        return dict(rows=self.rows, cols=self.cols,
                    x_windows=[list(w) if w else None for w in self.x_windows],
                    global_intervals=[list(self.intervals[w]) for w in self.global_intervals],
                    stages=len(self.stages), smem_bytes=self.smem_bytes)


def _read_offsets(offsets, symmetric: bool) -> list[int]:
    reads = set(offsets)
    if symmetric:
        reads |= {-o for o in offsets if o < 0}
    return sorted(reads)


def _merge(needs, chunk: int) -> list[tuple[int, int]]:
    """Row intervals [lo, hi), each rounded out to ``chunk`` rows, merged
    wherever they overlap or touch."""
    out = []
    for lo, hi in sorted((_floor(lo, chunk), _ceil(hi, chunk)) for lo, hi in needs):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(v) for v in out]


def _stages(sizes: list[int], cap: int) -> list[tuple[int, int]]:
    """Diagonals packed in order into stages of at most ``cap`` bytes."""
    out, k0, acc = [], 0, 0
    for k, size in enumerate(sizes):
        if k > k0 and acc + size > cap:
            out.append((k0, k))
            k0, acc = k, 0
        acc += size
    out.append((k0, len(sizes)))
    return out


def _layout(offsets, symmetric, cols, itemsize, rows, smem_budget):
    """(intervals, x windows, data windows, stages, smem bytes) at tile
    rows ``rows`` within ``smem_budget`` bytes, or None where a stage
    could not hold MIN_STAGE diagonals (or all K) beside the windows.
    Several stages take two buffers: the next stage's copies land in one
    while the CTA sums the other."""
    chunk = COPY_BYTES // itemsize
    intervals = _merge([(o, o + rows) for o in _read_offsets(offsets, symmetric)], chunk)
    shifts = [[0, -o] if symmetric and o < 0 else [0] for o in offsets]
    dwins = [_merge([(s, s + rows) for s in sh], chunk) for sh in shifts]
    dsize = [sum(hi - lo for lo, hi in w) * itemsize for w in dwins]
    wbytes = [(hi - lo) * cols * itemsize for lo, hi in intervals]
    need = min(sum(dsize), 2 * min(len(offsets), MIN_STAGE) * max(dsize))
    staged = list(intervals)
    # a window too large for shared memory is read from global memory,
    # largest first; only at the smallest tile and the largest budget
    while sum(b for b, w in zip(wbytes, staged) if w) + need > smem_budget:
        if smem_budget < SMEM_MAX or rows != TILE_ROWS[-1] or not any(staged):
            return None
        big = max((b, i) for i, (b, w) in enumerate(zip(wbytes, staged)) if w)[1]
        staged[big] = None
    xbytes = sum(b for b, w in zip(wbytes, staged) if w)
    if xbytes + sum(dsize) <= smem_budget:
        return intervals, staged, dwins, [(0, len(offsets))], xbytes + sum(dsize)
    stages = _stages(dsize, (smem_budget - xbytes) // 2)
    smem = xbytes + 2 * max(sum(dsize[k0:k1]) for k0, k1 in stages)
    return intervals, staged, dwins, stages, smem


def _pieces(lo: int, hi: int):
    """Rows [lo, hi) cut at multiples of 128 (relative to a tile start,
    itself a multiple of 128): each piece lies in one 128-row tile row, so
    it is one contiguous run of a column or a diagonal, and wholly inside
    or wholly outside [0, npad)."""
    out, a = [], lo
    while a < hi:
        b = min(hi, _floor(a, LANES) + LANES)
        out.append((a, b - a))
        a = b
    return out


def _table(offsets, symmetric, cols, rows, intervals, staged, dwins,
           stages) -> tuple[int, ...]:
    """The int32 words the kernel reads: head, x windows (lo, len, shared
    offset or -1 for global), stages (k0, k1, first copy, end copy), copies
    (k, first row, rows, offset in the stage buffer), one entry per
    diagonal (o, forward x offset or -1, its column stride, transposed x
    offset or -1, its column stride, forward data offset, transposed data
    offset, 0), x copies (first row, rows, shared offset of column 0,
    column stride). Every copy is one bulk copy a column: rows within one
    128-row tile row. Offsets count elements of shared memory: row r of
    the tile reads x column c at x offset + c * stride + r, and diagonal
    data at its data offset + r in the stage's buffer."""
    K = len(offsets)
    wins, x_off, xcopies, xo = [], [], [], 0
    for w in staged:
        if w is None:
            wins.append((0, 0, -1, 0))
            x_off.append(None)
        else:
            lo, hi = w
            wins.append((lo, hi - lo, xo, 0))
            x_off.append(xo)
            xcopies += [(a, n, xo + a - lo, hi - lo) for a, n in _pieces(lo, hi)]
            xo += (hi - lo) * cols
    copies, stage_rows, data_at, buf = [], [], [None] * K, 0
    for k0, k1 in stages:
        first, pos = len(copies), 0
        for k in range(k0, k1):
            data_at[k] = []
            for lo, hi in dwins[k]:
                copies += [(k, a, n, pos + a - lo) for a, n in _pieces(lo, hi)]
                data_at[k].append((lo, hi, pos))
                pos += hi - lo
        stage_rows.append((k0, k1, first, len(copies)))
        buf = max(buf, pos)

    def x_entry(row0):
        """(offset, column stride) at which row r's read of x at relative
        row row0 + r lands, or (-1, 0) where it is read from global."""
        w = next(w for w, (lo, hi) in enumerate(intervals) if lo <= row0 < hi)
        if staged[w] is None:
            return -1, 0
        lo, hi = staged[w]
        return x_off[w] + row0 - lo, hi - lo

    def data_entry(k, row0):
        """Row r's read of diagonal k at relative row row0 + r lands on
        buffer element entry + r."""
        lo, _, pos = next(w for w in data_at[k] if w[0] <= row0 < w[1])
        return pos - lo + row0

    diags = []
    for k, o in enumerate(offsets):
        xf, xfl = x_entry(o)
        xt = xtl = dto = 0
        if symmetric and o < 0:
            xt, xtl = x_entry(-o)
            dto = data_entry(k, -o)
        diags.append((o, xf, xfl, xt, xtl, data_entry(k, 0), dto, 0))
    win_base = HEAD_WORDS
    stage_base = win_base + WIN_WORDS * len(wins)
    copy_base = stage_base + STAGE_WORDS * len(stage_rows)
    diag_base = copy_base + COPY_WORDS * len(copies)
    xcopy_base = diag_base + DIAG_WORDS * K
    head = [rows, K, len(wins), len(stage_rows), xo, buf, win_base, stage_base,
            copy_base, diag_base, cols, int(symmetric), xcopy_base, len(xcopies)]
    head += [0] * (HEAD_WORDS - len(head))
    words = head + [v for t in (wins + stage_rows + copies + diags + xcopies) for v in t]
    if max(abs(v) for v in words) >= 2 ** 31:
        raise ValueError("a DIA window plan needs offsets and rows below 2**31")
    return tuple(words)


def _plan_at(offsets, symmetric, cols, itemsize, rows, smem_budget) -> WindowPlan | None:
    """The plan at tile rows ``rows`` within ``smem_budget`` bytes, or None
    where ``_layout`` finds none."""
    got = _layout(offsets, symmetric, cols, itemsize, rows, smem_budget)
    if got is None:
        return None
    intervals, staged, dwins, stages, smem = got
    table = _table(offsets, symmetric, cols, rows, intervals, staged, dwins, stages)
    return WindowPlan(offsets, symmetric, cols, itemsize, rows, tuple(intervals),
                      tuple(staged), tuple(tuple(w) for w in dwins), tuple(stages),
                      smem, table)


@functools.lru_cache(maxsize=256)
def window_plan(offsets: tuple[int, ...], symmetric: bool, nrhs: int,
                dtype: torch.dtype) -> WindowPlan:
    """The tile kernel's plan for these offsets, storage, block width and
    storage dtype: the largest R in TILE_ROWS whose windows and stages fit
    SMEM_TARGET bytes (all K in one stage, or stages of MIN_STAGE
    diagonals in two buffers); failing that R = 128 within SMEM_FIT, then
    within SMEM_MAX, with the largest x windows read from global memory
    until the rest fits. One object per key."""
    offsets = tuple(int(o) for o in offsets)
    if symmetric and max(offsets) > 0:
        raise ValueError("symmetric DIA stores offsets <= 0 only")
    key = (offsets, symmetric, min(nrhs, MAX_COLS),
           torch.empty(0, dtype=dtype).element_size())
    for rows in TILE_ROWS:
        plan = _plan_at(*key, rows, SMEM_TARGET)
        if plan is not None:
            return plan
    return (_plan_at(*key, TILE_ROWS[-1], SMEM_FIT)
            or _plan_at(*key, TILE_ROWS[-1], SMEM_MAX))


# The stream kernel's plan (csrc/dia_stream.cu), for symmetric storage at
# one column. Persistent CTAs walk runs of 128-row blocks; at the step of
# block q a CTA reads, for each cluster of read offsets (the stored offsets
# and -o for each o < 0, their blocks merged wherever they touch), one
# window of x blocks [q + lo, q + hi]; all K diagonals of blocks [q, q +
# hi] (the forward rows, and the transposed rows of the diagonals whose -o
# lies in the cluster of block 0); and, for each other cluster that holds
# some -o, the rows of those diagonals (a contiguous range of k) in its
# blocks. Each window slides one block a step, in a ring of ns slots: the
# forward window's width plus `depth` steps of copies in flight, and one
# common ns for the x and far windows, so that one slot counter serves them.
STREAM_MAX_K = 16       # diagonals the kernel holds (kMaxK)
STREAM_MAX_WIN = 8      # windows (kMaxWin)
STREAM_DEPTH = (2, 8)   # steps of copies in flight: the least, the most
STREAM_FLIGHT = 48 * 1024  # HBM bytes in flight an SM the depth aims at
#                            (about twice what hides HBM's latency at
#                            3.35 TB/s over 132 SMs)
STREAM_HEAD, STREAM_WIN_WORDS, STREAM_DIAG_WORDS = 16, 6, 8


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Where the stream kernel reads, in 128-row blocks relative to the
    step's block q. ``x_windows[c]`` = (lo, hi) of cluster c;
    ``data_windows[w]`` = (k0, k1, lo, hi), the forward window first;
    ``depth`` steps of copies in flight; ``ns_f``/``ns_o`` the slots of the
    forward ring and of every other ring; ``span`` the blocks from 0 to
    the centre of the nearest cluster above it (a plane), which the kernel
    takes as its run's length;
    ``smem_bytes`` its shared memory; ``words`` the int32 words the kernel
    takes by value."""

    offsets: tuple[int, ...]
    itemsize: int
    x_windows: tuple[tuple[int, int], ...]
    data_windows: tuple[tuple[int, int, int, int], ...]
    depth: int
    ns_f: int
    ns_o: int
    span: int
    smem_bytes: int
    words: tuple[int, ...]

    def summary(self) -> dict:
        """What a run prints about the plan."""
        return dict(x_windows=[list(w) for w in self.x_windows],
                    data_windows=[list(w) for w in self.data_windows],
                    depth=self.depth, ns_f=self.ns_f, ns_o=self.ns_o, span=self.span,
                    smem_bytes=self.smem_bytes)


def _clusters(reads) -> list[tuple[int, int]]:
    """The blocks [lo, hi] each read offset's 128 rows reach, merged
    wherever they overlap or touch."""
    out = []
    for lo, hi in sorted((r // LANES, (r + LANES - 1) // LANES) for r in reads):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(c) for c in out]


@functools.lru_cache(maxsize=256)
def stream_plan(offsets: tuple[int, ...], dtype: torch.dtype) -> StreamPlan | None:
    """The stream kernel's plan for symmetric storage with these offsets,
    or None where they do not span clusters or the kernel cannot hold them:
    fewer than two clusters, more than STREAM_MAX_K diagonals or
    STREAM_MAX_WIN windows, offsets not ascending, or rings that miss
    SMEM_MAX at the least depth. The depth is the largest up to
    STREAM_FLIGHT's that fits. One object per key."""
    offsets = tuple(int(o) for o in offsets)
    if max(offsets) > 0:
        raise ValueError("symmetric DIA stores offsets <= 0 only")
    K = len(offsets)
    if K > STREAM_MAX_K or list(offsets) != sorted(set(offsets)):
        return None
    itemsize = torch.empty(0, dtype=dtype).element_size()
    clusters = _clusters(_read_offsets(offsets, True))
    if len(clusters) < 2:
        return None

    def cluster_of(r):
        return next(c for c, (lo, hi) in enumerate(clusters) if lo <= r // LANES <= hi)

    mid = next((c for c, (lo, hi) in enumerate(clusters) if lo <= 0 <= hi), None)
    trans = [k for k, o in enumerate(offsets) if o < 0]
    # the forward window: all K diagonals, blocks [0, hi]
    f_hi = max([(LANES - 1 - offsets[k]) // LANES for k in trans
                if cluster_of(-offsets[k]) == mid], default=0)
    windows = [(0, K, 0, f_hi)]
    dwin = {k: 0 for k in trans if cluster_of(-offsets[k]) == mid}
    for c in sorted({cluster_of(-offsets[k]) for k in trans} - {mid}):
        ks = [k for k in trans if cluster_of(-offsets[k]) == c]
        dwin.update({k: len(windows) for k in ks})
        windows.append((ks[0], ks[-1] + 1, min(-offsets[k] // LANES for k in ks),
                        max((LANES - 1 - offsets[k]) // LANES for k in ks)))
    nwin = len(clusters) + len(windows)
    if nwin > STREAM_MAX_WIN:
        return None
    width = [hi - lo + 1 for lo, hi in clusters] + [hi - lo + 1 for *_, lo, hi in windows]
    o_width = max(width[:len(clusters)] + width[len(clusters) + 1:])
    nk = [1] * len(clusters) + [k1 - k0 for k0, k1, _, _ in windows]
    step_bytes = (K + 2) * LANES * itemsize
    for depth in range(min(max(-(-STREAM_FLIGHT // step_bytes), STREAM_DEPTH[0]),
                           STREAM_DEPTH[1]), STREAM_DEPTH[0] - 1, -1):
        ns_f, ns_o = width[len(clusters)] + depth, o_width + depth
        ns = [ns_o] * len(clusters) + [ns_f] + [ns_o] * (len(windows) - 1)
        sizes = [n * k * LANES for n, k in zip(ns, nk)]
        if sum(sizes) * itemsize <= SMEM_MAX:
            break
    else:
        return None
    base = [sum(sizes[:w]) for w in range(nwin)]
    # the read offsets are symmetric about 0, so of two clusters or more one
    # lies above it
    span = max(1, round(min((lo + hi) / 2 for lo, hi in clusters if lo + hi > 0)))
    smem = sum(sizes) * itemsize
    pad_w = [0] * (STREAM_MAX_WIN - nwin)
    los = [lo for lo, _ in clusters] + [lo for *_, lo, _ in windows]
    head = [K, len(clusters), nwin, ns_f, ns_o, depth, span, smem]
    words = head + [0] * (STREAM_HEAD - len(head))
    words += [0] * len(clusters) + [k0 for k0, *_ in windows] + pad_w
    words += nk + pad_w
    words += los + pad_w
    words += width + pad_w
    words += ns + pad_w
    words += base + pad_w
    diag = {name: [0] * STREAM_MAX_K for name in
            ("xf_rel", "xf_base", "xt_rel", "xt_base", "dt_far", "dt_rel", "dt_base",
             "dt_stride")}
    for k, o in enumerate(offsets):
        c = cluster_of(o)
        diag["xf_rel"][k], diag["xf_base"][k] = o - clusters[c][0] * LANES, base[c]
        diag["xt_base"][k] = -1
        if o < 0:
            c = cluster_of(-o)
            diag["xt_rel"][k], diag["xt_base"][k] = -o - clusters[c][0] * LANES, base[c]
            w = dwin[k]
            k0, k1, lo, _ = windows[w]
            diag["dt_far"][k] = int(w > 0)
            diag["dt_rel"][k] = -o - lo * LANES
            diag["dt_base"][k] = base[len(clusters) + w] + (k - k0) * LANES
            diag["dt_stride"][k] = (k1 - k0) * LANES
    for v in diag.values():
        words += v
    if max(abs(v) for v in words) >= 2 ** 31:
        raise ValueError("a DIA stream plan needs offsets below 2**31")
    return StreamPlan(offsets, itemsize, tuple(clusters), tuple(windows), depth, ns_f,
                      ns_o, span, smem, tuple(words))


@functools.lru_cache(maxsize=64)
def device_zeros(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """n zeros on ``device``, which the stream kernel copies in for blocks
    outside a shard; one buffer per key is kept."""
    return torch.zeros(n, dtype=dtype, device=device)


@functools.lru_cache(maxsize=256)
def device_window_plan(offsets: tuple[int, ...], symmetric: bool, nrhs: int,
                       dtype: torch.dtype, device: torch.device
                       ) -> tuple[WindowPlan, torch.Tensor]:
    """``window_plan`` and its table as an int32 tensor on ``device``, made
    once per key and kept."""
    plan = window_plan(offsets, symmetric, nrhs, dtype)
    return plan, torch.tensor(plan.table, dtype=torch.int32, device=device)


# Which kernel an apply launches (``route``): dia_spmm runs the tile kernel,
# dia_sym_spmv the tile kernel or the stream kernel, dia_spmv and
# dia_sym_spmm choose by shape. From the H100 (PERF.md): dia_spmv_rows, with
# K at compile time, beat both the loop kernel and the tile kernel at K = 5
# and 9 on every grid measured, 41k to 10M rows; at K = 65 and 297 the loop
# kernel beat the tile kernel in every dtype; dia_sym_spmm's direct kernel
# without its per-column mask beat the tile kernel at every Laplacian block
# measured; and the tile kernel reached 53% of its bound on HPCG's 27-point
# operator, where its plan misses SMEM_TARGET and stages 35 windows a tile,
# against 78-80% on the 2-D Laplacian, whose plan fits.
ROWS_K = (5, 9)          # the K dia_spmv_rows is built for (csrc/spmv_dia.cu)
ROWS_UNALIGNED = 2       # 16 bytes of rows a thread (fp32, bf16) where at
#                          most this many offsets are not multiples of that
#                          count: on the Laplacian (+-1) faster or tied from
#                          1M to 10M rows; on the AMG levels (six) 14-18%
#                          slower than one row a thread; fp64 never faster


@dataclasses.dataclass(frozen=True)
class Route:
    """The design an apply launches: ``kernel`` "rows" (dia_spmv_rows,
    ``rows_per_thread`` rows a thread), "tile" (the tile kernel of
    csrc/dia_window.cuh, with its ``window_plan``), "stream" (the
    persistent kernel of csrc/dia_stream.cu, with its ``stream_plan``) or
    "loop" (one row a thread, a runtime loop over K that reads the offsets
    from the card: dia_spmv_kernel, or dia_sym_spmm's direct kernel)."""

    kernel: str
    rows_per_thread: int = 1


@functools.lru_cache(maxsize=256)
def route(offsets: tuple[int, ...], symmetric: bool, block: bool,
          dtype: torch.dtype) -> Route:
    """The design an apply launches: of dia_spmv (vanilla storage), dia_sym_spmv
    (symmetric), or with ``block`` dia_spmm (vanilla) and dia_sym_spmm
    (symmetric), for these offsets and storage ``dtype``. Made once per key
    and kept. No choice depends on the rows or the block width: on the
    card none changed from 41k to 10M rows, nor from 3 to 11 columns.
    dia_sym_spmv runs the stream kernel where the tile kernel's plan misses
    SMEM_TARGET at every R and the read offsets form at least two clusters
    that ``stream_plan`` holds: offsets that span planes."""
    if (symmetric and not block and stream_plan(offsets, dtype) is not None
            and window_plan(offsets, True, 1, dtype).smem_bytes > SMEM_TARGET):
        return Route("stream")
    if symmetric != block:  # dia_sym_spmv, dia_spmm
        return Route("tile")
    if symmetric or len(offsets) not in ROWS_K:  # dia_sym_spmm; dia_spmv at other K
        return Route("loop")
    itemsize = torch.empty(0, dtype=dtype).element_size()
    wide = COPY_BYTES // itemsize
    unaligned = sum(o % wide != 0 for o in offsets)
    if itemsize < 8 and unaligned <= ROWS_UNALIGNED:
        return Route("rows", wide)
    return Route("rows", 1)


# the C entry point of each (route kernel, symmetric, block) a wrapper launches
ENTRIES = {("rows", False, False): "dia_spmv_rows", ("loop", False, False): "dia_spmv",
           ("loop", True, True): "dia_sym_spmm", ("tile", True, False): "dia_sym_spmv",
           ("tile", False, True): "dia_spmm", ("stream", True, False): "dia_sym_spmv_stream"}


@functools.lru_cache(maxsize=256)
def entry(r: Route, offsets: tuple[int, ...], symmetric: bool, block: bool, nrhs: int,
          dtype: torch.dtype, device: torch.device) -> tuple[str, tuple, tuple]:
    """(name, arguments, kept) for route ``r``: the C entry point of csrc/
    and its arguments between (data, x, y, npad, ndiags) and (nshards,
    stream) — ``block`` for the block wrappers (dia_spmm, dia_sym_spmm),
    which take nrhs too — and the objects the arguments point into. Made
    once per key and kept, so the pointers stay valid."""
    kind = (r.kernel, symmetric, block)
    if kind not in ENTRIES:
        raise ValueError(f"no DIA kernel runs route {r} on "
                         f"{'symmetric' if symmetric else 'vanilla'} storage"
                         f"{' blocks' if block else ''}")
    name = f"{ENTRIES[kind]}_{DTYPES[dtype]}"
    if r.kernel == "rows":  # the offsets in host memory, passed by value
        offs = (ctypes.c_longlong * len(offsets))(*offsets)
        return name, (ctypes.addressof(offs), r.rows_per_thread), (offs,)
    if r.kernel == "loop":
        offs = device_offsets(offsets, device)
        return name, (offs.data_ptr(),) + ((nrhs,) if block else ()), (offs,)
    if r.kernel == "stream":  # the plan's words in host memory, passed by value
        plan = stream_plan(offsets, dtype)
        if plan is None:
            raise ValueError(f"the DIA stream kernel cannot hold offsets {offsets}")
        words = (ctypes.c_int * len(plan.words))(*plan.words)
        zeros = device_zeros(len(offsets) * LANES, dtype, device)
        return name, (ctypes.addressof(words), zeros.data_ptr()), (words, zeros)
    plan, table = device_window_plan(offsets, symmetric, nrhs, dtype, device)
    args = (table.data_ptr(), plan.rows, plan.smem_bytes) + ((nrhs,) if block else ())
    return name, args, (table,)


def launch(r: Route, data: torch.Tensor, x2: torch.Tensor, offsets: tuple[int, ...],
           symmetric: bool, block: bool) -> torch.Tensor:
    """Launch route ``r`` on CUDA tensors that ``_check`` passed: one launch
    for all shards (and columns), counted under ``KEYS``; raises if the
    launch fails. The wrappers call it with ``route``'s choice."""
    nd, nr = data.shape[0], data.shape[1]
    nrhs = x2.shape[1] // LANES
    if r.kernel in ("tile", "stream") or r.rows_per_thread > 1:
        _check_aligned(data, x2)
    name, args, _ = entry(r, offsets, symmetric, block, nrhs, data.dtype, x2.device)
    y2 = torch.empty_like(x2)
    _build.launch(name, x2.device, data.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                  nr * LANES, len(offsets), *args, nd,
                  key=STREAM_KEY if r.kernel == "stream" else KEYS[symmetric, block])
    return y2


def _lanes_ok(lanes: int, block: bool) -> bool:
    """x's width: 128 lanes, or nrhs*128 (the SpMM lane layout) for a block
    apply."""
    return lanes == LANES or (block and lanes > 0 and lanes % LANES == 0)


def _check(data: torch.Tensor, x2: torch.Tensor, offsets, symmetric: bool,
           block: bool = False):
    if data.device != x2.device:
        raise ValueError(f"data on {data.device} but x on {x2.device}")
    if data.dtype not in DTYPES or x2.dtype != data.dtype:
        raise TypeError(f"DIA apply takes float32, float64 or bfloat16 data "
                        f"and x of the same dtype, got {data.dtype} and {x2.dtype}")
    k = len(offsets)
    if k < 1:
        raise ValueError("a DIA apply needs at least one diagonal")
    if symmetric and max(offsets) > 0:
        raise ValueError("symmetric DIA stores offsets <= 0 only")
    if data.dim() != 3 or data.shape[2] != k * LANES:
        raise ValueError(f"data must be (D, R, {k}*128), got {tuple(data.shape)}")
    nd, nr = data.shape[0], data.shape[1]
    if x2.dim() != 2 or x2.shape[0] != nd * nr or not _lanes_ok(x2.shape[1], block):
        raise ValueError(f"x must be ({nd * nr}, {'nrhs*' if block else ''}128) "
                         f"for data {tuple(data.shape)}, got {tuple(x2.shape)}")
    if not (data.is_contiguous() and x2.is_contiguous()):
        raise ValueError("DIA apply takes contiguous data and x")


def _check_aligned(data: torch.Tensor, x2: torch.Tensor) -> None:
    """The tile kernel copies 16-byte chunks, and dia_spmv_rows at several
    rows a thread reads 16-byte loads: data and x must start on 16 bytes (a
    lane-layout view that starts at a whole row always does)."""
    if data.data_ptr() % COPY_BYTES or x2.data_ptr() % COPY_BYTES:
        raise ValueError("the DIA tile kernel and 16-byte rows take data and x "
                         "that start on 16 bytes")


def spmv_dia_stacked(
    data: torch.Tensor,
    x2: torch.Tensor,
    offsets: tuple[int, ...],
    symmetric: bool,
) -> torch.Tensor:
    """Stacked-shard lane-layout apply, one launch for all D shards:
    data (D, R, K*128), x2 (D*R, 128) -> y2 (D*R, 128). Shard s reads only
    its own R*128 entries of x (zero outside)."""
    _check(data, x2, offsets, symmetric)
    if x2.device.type == "cpu":
        return spmv_dia_stacked_plain(data, x2, offsets, symmetric)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no DIA kernel for device {x2.device}")
    offsets = tuple(offsets)
    return launch(route(offsets, symmetric, False, data.dtype), data, x2, offsets,
                  symmetric, False)


def spmv_dia_2d(a: DiaMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Lane-layout SpMV: x2 (nrows_pad/128, 128) -> y (nrows_pad/128, 128).
    Dispatches to the symmetric kernel when ``a.symmetric``."""
    return spmv_dia_stacked(a.data.unsqueeze(0), x2, a.offsets, a.symmetric)


def spmv_dia(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Flat-vector SpMV: x of length nrows_pad -> y of length nrows_pad."""
    if x.shape != (a.nrows_pad,):
        raise ValueError(f"x must have length {a.nrows_pad}, got {tuple(x.shape)}")
    return spmv_dia_2d(a, x.view(-1, LANES)).view(-1)
