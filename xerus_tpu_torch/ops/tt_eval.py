"""K3: a TT evaluated at M index tuples, hand-written in CUDA for Hopper.

Counterpart of ``xerus_tpu/ops/pallas_tt_eval.py`` (``_tt_eval_kernel``,
entry ``tt_eval_at_points_pallas``) and of the XLA path of
``xerus_tpu/algorithms/measurements.py`` ``_evaluate_tt_at_points``.  The
kernel is ``csrc/tt_eval.cu``; its header says what bounds it on the card
and how the design answers.

``tt_eval_at_points`` takes the plain version
``tt_eval_at_points_reference`` for tensors on the CPU, and only there.
For CUDA tensors it launches the kernel at every M and every rank, or
raises: the TPU's gates (M >= 512, ranks <= 128) and its f32 downcast of
f64 input are not carried over.

What bounds the kernel is the shared-memory load path: a warp whose lanes
read from different core slices is delivered 128 bytes a cycle, so a
measurement that gathers its own (r, r) slice at every site costs d r^2
loads however they are laid out.  The wrapper therefore hands the kernel a
*plan* (``tt_eval_plan``, plain Python, computed from the shapes and M
alone and cached): the cores at their true shapes through a by-value table
of pointers and strides (no device operation, no padded stack), grouped
into runs of neighbouring sites.  Each block multiplies a run's cores into
one table in shared memory, indexed by the run's combined index, before it
takes measurements; a measurement then does one small product per run
instead of one per site.  A table is built once per block and pays off
over the block's measurements, so one rule decides: blocks that take at
least MERGE_MIN_PER_BLOCK measurements merge, fewer keep one group per
site.  ``build_tables`` and
``eval_from_tables`` are the plain model of what the kernel does with a
plan, offsets included; the CPU tests hold them against the plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import build

MAX_SITES = 24            # sites (and groups) the by-value table holds
SMEM_LIMIT = 232_448 - 128   # dynamic shared memory a block may opt in to,
                             # less the kernel's few static bytes
TILE = 32                 # measurements per warp tile
# frontier capacity R of each instantiation -> threads per block
THREADS = {8: 1024, 16: 512, 32: 256}
MIN_THREADS = 256         # hands for staging and building the tables
MERGE_MAX_R = 16          # the R=32 instantiation takes one group per site
MAX_GROUP_SLICES = 256    # index combinations one run merges
# elements of one run's table or intermediate buffer (the build's time goes
# with them): in f64 a quarter of the block's shared memory
TABLE_CAP_ELEMS = SMEM_LIMIT // 32
# measurements per block from which merged runs pay for their build
# (examples/k3_split.py --crossover on an H100, the completion slice's shape)
MERGE_MIN_PER_BLOCK = 1024
ROUTE_SMEM, ROUTE_GENERIC = "shared-memory tables", "device-memory cores"


def tt_eval_at_points_reference(cores: Sequence[torch.Tensor],
                                positions: torch.Tensor) -> torch.Tensor:
    """values[m] = TT[positions[m]]: one gather and one batched product
    per site, the frontier (M, r) written between sites, as the JAX
    package's XLA path does.  ``positions`` is (M, d) int64 on the cores'
    device."""
    M = positions.shape[0]
    F = cores[0].new_ones((M, 1))
    for k, C in enumerate(cores):
        taken = C[:, positions[:, k], :]             # (rl, M, rr)
        F = torch.einsum("ma,amb->mb", F, taken)
    return F[:, 0]


# ---------------------------------------------------------------------------
# the plan: everything the kernel is told, computed from shapes alone


class SitePlan(NamedTuple):
    rl: int
    n: int
    rr: int
    ccode: int     # step variant for (rl, rr)
    dst: int       # where the block stages the core: element offset,
    dpitch: int    # elements between slices [i],
    drow: int      # between rows [a]; columns zero-padded to this width
    dot: int       # 1: the last run is this site alone, staged as rows [i][a]
    estart: int    # elements staged before this site


class GroupPlan(NamedTuple):
    first: int     # sites first..last, merged into one table
    last: int
    off: int       # table offset in shared memory, elements
    pitch: int     # elements between slices [j]
    rowpitch: int  # elements between rows [a] (the dot group: its one row)
    code: int      # step variant; DOT_CODE for the last group
    rl: int
    buf_a: int     # intermediate products of a run of 3 or more sites:
    buf_b: int     # after an odd number of steps in a, an even number in b
    slices: int    # product of the sites' mode sizes


class StepPlan(NamedTuple):
    """One product of the build: rows [j][a] at src, times site k's staged
    core, into rows [j * n_k + i][a] at dst."""
    src: int
    src_pitch: int
    src_row: int
    core: int
    core_pitch: int
    core_row: int
    ccode: int
    rl_k: int
    n_k: int
    dst: int
    dst_pitch: int
    dst_row: int
    rows: int      # prefix * n_k * rl_g
    rl_g: int
    dot: int       # 1: the last run's last site, column 0 into rows [jn][a]
    start: int     # the thread that takes row 0
    sync: int      # 1: the block synchronizes after this step (level's end)


class Plan(NamedTuple):
    route: str
    positions: str            # "bulk copies" or "plain loads"
    R: int                    # frontier capacity of the instantiation
    threads: int
    blocks: int
    work_warps: int           # warps of a block that take measurements
    stage_bytes: int          # of a working warp's one tile of positions
    ring_off: int             # bytes
    bar_off: int              # bytes
    smem_bytes: int
    early: int                # 1: the build's scratch lies beside the ring,
                              # so the first tiles are fetched under the build
    stage_total: int          # elements the block stages
    sites: Tuple[SitePlan, ...]
    groups: Tuple[GroupPlan, ...]
    steps: Tuple[StepPlan, ...]
    loads_per_entry: int      # core elements one measurement reads

    def describe(self) -> str:
        if self.route != ROUTE_SMEM:
            where = f"registers (R={self.R})" if self.R else "device memory"
            return (f"{self.route} (frontier in {where}), positions by "
                    "plain loads")
        runs = "+".join(str(g.last - g.first + 1) for g in self.groups)
        return (f"{self.route} (R={self.R}, sites grouped {runs}, "
                f"{self.loads_per_entry} core elements per entry, "
                f"{self.threads} threads ({self.work_warps} warps on "
                f"measurements) x {self.blocks} blocks, "
                f"{self.smem_bytes} B), positions by {self.positions}")


DOT_CODE = 9


def _width_class(x: int, R: int, vec: int) -> Tuple[int, int]:
    """(index, width): the narrowest of R, R/2, R/4 that holds ``x`` columns
    and a whole 16-byte vector; index 0 is R."""
    for idx in (2, 1, 0):
        w = R >> idx
        if w >= x and w >= vec:
            return idx, w
    raise ValueError(f"{x} columns do not fit a frontier of {R}")


def _row_class(rl: int, R: int) -> int:
    """0: up to R rows, 1: up to R/2, 2: one row."""
    return 2 if rl == 1 else (1 if rl <= R // 2 else 0)


def _slice_pitch(elems: int, itemsize: int) -> int:
    """Elements between two slices: an odd number of 16-byte units, so that
    the slices a warp's lanes pick at one (row, column) spread over the
    banks."""
    units = -(-elems * itemsize // 16)
    return (units | 1) * 16 // itemsize


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def _frontier_capacity(shapes) -> Optional[int]:
    r = max(max(s[0], s[2]) for s in shapes)
    for R in sorted(THREADS):
        if r <= R:
            return R
    return None


def _core_layout(shape, R, vec, itemsize):
    """(slice pitch, row pitch, step variant) of one staged core."""
    rl, _n, rr = shape
    cw_idx, crow = _width_class(rr, R, vec)
    return (_slice_pitch(rl * crow, itemsize), crow,
            _row_class(rl, R) * 3 + cw_idx)


@lru_cache(maxsize=4096)
def _group_geometry(shapes, first, last, is_last, R, vec, itemsize):
    """Of the run first..last: (slices, pitch, rowpitch, code, table
    elements, elements of staged cores in scratch, elements of one
    intermediate buffer, build loads, elements one measurement reads)."""
    rl, rr = shapes[first][0], shapes[last][2]
    slices = 1
    for s in shapes[first:last + 1]:
        slices *= s[1]
    if is_last:       # only column 0 of the last site is wanted: a dot
        _idx, rowpitch = _width_class(rl, R, vec)
        pitch = _slice_pitch(rowpitch, itemsize)
        code, per_entry = DOT_CODE, rowpitch
    else:
        cw_idx, rowpitch = _width_class(rr, R, vec)
        pitch = _slice_pitch(rl * rowpitch, itemsize)
        code = _row_class(rl, R) * 3 + cw_idx
        per_entry = rl * rowpitch
    staged = inter = build_loads = 0
    if last > first:
        prefix = 1
        for k in range(first, last + 1):
            cpitch, crow, _code = _core_layout(shapes[k], R, vec, itemsize)
            staged += _align(shapes[k][1] * cpitch, 16 // itemsize)
            prefix *= shapes[k][1]
            if k > first:
                build_loads += prefix * rl * shapes[k][0] * (1 + crow)
                if k < last:
                    inter = max(inter, prefix * rl * crow)
    return (slices, pitch, rowpitch, code, slices * pitch, staged,
            _align(inter, 16 // itemsize), build_loads, per_entry)


def merged_runs(shapes, itemsize: int):
    """The split into runs [(first, last), ...] that reads the fewest core
    elements per measurement (ties: the fewest build loads); no run of more
    than MAX_GROUP_SLICES index combinations, no table or intermediate
    buffer above TABLE_CAP_ELEMS.  None where the ranks take one run per
    site."""
    R = _frontier_capacity(shapes)
    if R is None or R > MERGE_MAX_R:
        return None
    d, vec = len(shapes), 16 // itemsize
    best = [((0, 0), [])] + [None] * d
    for end in range(1, d + 1):
        for first in range(end):
            if best[first] is None:
                continue
            (slices, _p, _r, _c, elems, _staged, inter, build_loads,
             per_entry) = _group_geometry(shapes, first, end - 1, end == d,
                                          R, vec, itemsize)
            if end - first > 1 and (slices > MAX_GROUP_SLICES
                                    or elems > TABLE_CAP_ELEMS
                                    or inter > TABLE_CAP_ELEMS):
                continue
            cost = (best[first][0][0] + per_entry,
                    best[first][0][1] + build_loads)
            if best[end] is None or cost < best[end][0]:
                best[end] = (cost, best[first][1] + [(first, end - 1)])
    return best[d][1]


def _fit(geos, work_warps, stage_bytes, itemsize):
    """Lay tables, ring (one tile per working warp), scratch and barriers
    into a block's shared memory: (working warps, early, table bytes, ring
    bytes incl. a scratch beside it, scratch offset, total) or None.  The
    scratch beside the ring if both fit, else inside it; fewer working warps
    when even that does not fit."""
    table_bytes = sum(_align(g[4], 128 // itemsize) for g in geos) * itemsize
    scratch_bytes = _align(sum(g[5] + 2 * g[6] for g in geos) * itemsize, 128)
    while True:
        bar_bytes = _align(work_warps * 8, 128)
        ring_bytes = work_warps * stage_bytes
        free = SMEM_LIMIT - table_bytes - bar_bytes
        if ring_bytes + scratch_bytes <= free:
            return (work_warps, 1, table_bytes, ring_bytes + scratch_bytes,
                    table_bytes + ring_bytes,
                    table_bytes + ring_bytes + scratch_bytes + bar_bytes)
        if max(ring_bytes, scratch_bytes) <= free:
            ring_bytes = max(ring_bytes, scratch_bytes)
            return (work_warps, 0, table_bytes, ring_bytes, table_bytes,
                    table_bytes + ring_bytes + bar_bytes)
        if work_warps == 1:
            return None
        work_warps //= 2


@lru_cache(maxsize=256)
def tt_eval_plan(shapes: Tuple[Tuple[int, int, int], ...], itemsize: int,
                 M: int, sms: int, positions_aligned: bool = True,
                 groups: Optional[Tuple[Tuple[int, int], ...]] = None) -> Plan:
    """The launch plan for cores of ``shapes`` (rl, n, rr), ``itemsize`` 4
    or 8, and M measurements on a card of ``sms`` multiprocessors.
    ``positions_aligned``: the positions start on a 16-byte boundary (bulk
    copies need it).  ``groups`` overrides the choice of runs [(first,
    last), ...] (for tests and measurements).

    One rule chooses the runs: ``merged_runs`` when a block takes at least
    MERGE_MIN_PER_BLOCK measurements and the merged tables leave every
    working warp its tile in shared memory, else one run per site."""
    d = len(shapes)
    vec = 16 // itemsize
    R = _frontier_capacity(shapes)
    # R here: the register frontier's capacity (8 or 32), 0 for ranks above
    # 32, whose frontier lives in device memory
    generic_R = 0 if R is None else (8 if R == 8 else 32)
    generic = Plan(ROUTE_GENERIC, "plain loads", generic_R, 256,
                   max(1, min(8 * sms, -(-M // 256))), 8, 0, 0, 0, 0, 0, 0,
                   (), (), (), sum(s[0] * s[2] for s in shapes))
    if R is None or d > MAX_SITES:
        return generic
    if groups is not None and R > MERGE_MAX_R and any(
            last > first for first, last in groups):
        raise ValueError(f"ranks above {MERGE_MAX_R} take one group per site")
    stage_bytes = _align(TILE * d * 8, 128)
    # one staging pass of four elements per thread covers the cores
    staging_threads = _align(sum(_core_layout(sh, R, vec, itemsize)[1]
                                 * sh[0] * sh[1] for sh in shapes), 128) // 4
    tiles = -(-M // TILE)
    # one block per SM at most, as many working warps as it takes to cover
    # the tiles; at least MIN_THREADS threads and one staging pass's worth,
    # since staging and building want hands even when few warps get tiles
    blocks = max(1, min(sms, tiles))
    want_warps = min(THREADS[R] // 32, max(1, -(-tiles // blocks)))
    threads = min(THREADS[R], max(32 * want_warps, MIN_THREADS,
                                  staging_threads))
    per_site = [(k, k) for k in range(d)]
    if groups is not None:
        candidates = [list(groups)]
    elif R <= MERGE_MAX_R and M >= MERGE_MIN_PER_BLOCK * blocks:
        candidates = [merged_runs(shapes, itemsize), per_site]
    else:
        candidates = [per_site]
    best = None
    for runs in candidates:
        geos = [_group_geometry(shapes, first, last, last == d - 1, R, vec,
                                itemsize) for first, last in runs]
        fit = _fit(geos, want_warps, stage_bytes, itemsize)
        if fit is not None and (fit[0] == want_warps
                                or runs is candidates[-1]):
            best = (runs, geos, fit)
            break
    if best is None:
        return generic
    runs, geos, fit = best
    work_warps, early, table_bytes, ring_bytes, scratch_off, smem = fit
    # offsets: tables first, then the scratch inside the ring's bytes
    splans: List[Optional[SitePlan]] = [None] * d
    gplans, off, scratch, estart, loads = [], 0, scratch_off // itemsize, 0, 0
    for (first, last), geo in zip(runs, geos):
        (slices, pitch, rowpitch, code, elems, _staged, inter, _b,
         per_entry) = geo
        buf_a = buf_b = 0
        if last == first:
            rl, n, rr = shapes[first]
            dot = int(code == DOT_CODE)
            _cp, _cr, ccode = _core_layout(shapes[first], R, vec, itemsize)
            splans[first] = SitePlan(rl, n, rr, ccode, off, pitch, rowpitch,
                                     dot, estart)
            estart += n * rowpitch * (1 if dot else rl)
        else:
            for k in range(first, last + 1):
                rl, n, rr = shapes[k]
                cpitch, crow, ccode = _core_layout(shapes[k], R, vec,
                                                   itemsize)
                splans[k] = SitePlan(rl, n, rr, ccode, scratch, cpitch, crow,
                                     0, estart)
                estart += n * rl * crow
                scratch += _align(n * cpitch, 16 // itemsize)
            buf_a, buf_b = scratch, scratch + inter
            scratch += 2 * inter
        gplans.append(GroupPlan(first, last, off, pitch, rowpitch, code,
                                shapes[first][0], buf_a, buf_b, slices))
        off += _align(elems, 128 // itemsize)
        loads += per_entry
    return Plan(ROUTE_SMEM,
                "bulk copies" if positions_aligned else "plain loads",
                R, threads, blocks, work_warps, stage_bytes, table_bytes,
                table_bytes + ring_bytes, smem, early, estart,
                tuple(splans), tuple(gplans),
                _build_steps(splans, gplans, threads), loads)


def _build_steps(sites, groups, threads) -> Tuple[StepPlan, ...]:
    """The build's products, level by level (one site of every run per
    level); the runs of a level start on different warps so that they
    proceed side by side and no warp works through two of them in turn
    (until the rows outnumber the threads)."""
    steps = []
    levels = max(g.last - g.first + 1 for g in groups)
    for lvl in range(1, levels):
        start = 0
        for gi, g in enumerate(groups):
            if g.last - g.first < lvl:
                continue
            k = g.first + lvl
            s, sp = sites[k], sites[k - 1]
            prefix = 1
            for q in range(g.first, k):
                prefix *= sites[q].n
            if lvl == 1:
                src, src_pitch, src_row = sp.dst, sp.dpitch, sp.drow
            else:
                src = g.buf_a if (lvl - 1) & 1 else g.buf_b
                src_pitch, src_row = g.rl * sp.drow, sp.drow
            fin = k == g.last
            dst = g.off if fin else (g.buf_a if lvl & 1 else g.buf_b)
            rows = prefix * s.n * g.rl
            steps.append(StepPlan(
                src, src_pitch, src_row, s.dst, s.dpitch, s.drow, s.ccode,
                s.rl, s.n, dst, g.pitch if fin else g.rl * s.drow,
                g.rowpitch if fin else s.drow, rows, g.rl,
                int(fin and gi == len(groups) - 1), start, 0))
            start = _align(start + rows, 32) % threads   # whole warps
        steps[-1] = steps[-1]._replace(sync=1)
    return tuple(steps)


# ---------------------------------------------------------------------------
# the plain model of the kernel's two phases, at the plan's offsets


def build_tables(plan: Plan, cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """The block's shared memory after the kernel's first phase, as one
    flat tensor of elements (NaN where nothing was written): every core
    staged where the plan says, then every run of two or more sites
    multiplied site by site into its table, through the run's two
    intermediate buffers in the scratch that aliases the position ring."""
    itemsize = cores[0].element_size()
    image = torch.full((plan.smem_bytes // itemsize,), float("nan"),
                       dtype=cores[0].dtype)
    staged = 0
    for s, c in zip(plan.sites, cores):
        assert s.estart == staged
        for i in range(s.n):
            if s.dot:
                base = s.dst + i * s.dpitch
                image[base:base + s.drow] = 0
                image[base:base + s.rl] = c[:, i, 0]
                staged += s.drow
                continue
            for a in range(s.rl):
                base = s.dst + i * s.dpitch + a * s.drow
                image[base:base + s.drow] = 0
                image[base:base + s.rr] = c[a, i, :]
                staged += s.drow
    assert staged == plan.stage_total
    for st in plan.steps:
        for jn in range(st.rows // st.rl_g):
            j, i = divmod(jn, st.n_k)
            for a in range(st.rl_g):
                src = st.src + j * st.src_pitch + a * st.src_row
                F = image[src:src + st.rl_k]
                G = torch.zeros(st.core_row, dtype=image.dtype)
                for c in range(st.rl_k):
                    row = st.core + i * st.core_pitch + c * st.core_row
                    G += F[c] * image[row:row + st.core_row]
                if st.dot:
                    image[st.dst + jn * st.dst_pitch + a] = G[0]
                else:
                    base = st.dst + jn * st.dst_pitch + a * st.dst_row
                    image[base:base + st.dst_row] = G[:st.dst_row]
            if st.dot:      # the dot row's padding up to its class width
                base = st.dst + jn * st.dst_pitch
                image[base + st.rl_g:base + st.dst_row] = 0
    return image


def eval_from_tables(plan: Plan, image: torch.Tensor,
                     positions: torch.Tensor):
    """The kernel's second phase on the tables of ``build_tables``: (values,
    number of measurements with an index outside its site's mode size).
    Such a measurement reads slice 0 and comes out NaN."""
    M = positions.shape[0]
    F = torch.zeros((M, max(plan.R, 1)), dtype=image.dtype)
    F[:, 0] = 1
    ok = torch.ones((M,), dtype=torch.bool)
    last_group = len(plan.groups) - 1
    for gi, g in enumerate(plan.groups):
        j = torch.zeros((M,), dtype=torch.int64)
        for k in range(g.first, g.last + 1):
            n = plan.sites[k].n
            valid = (positions[:, k] >= 0) & (positions[:, k] < n)
            ok &= valid
            j = j * n + torch.where(valid, positions[:, k], 0)
        base = g.off + j * g.pitch
        if gi == last_group:
            cols = base[:, None] + torch.arange(g.rowpitch)[None, :]
            vals = (F[:, :g.rl] * image[cols][:, :g.rl]).sum(1)
            F = torch.zeros_like(F)
            F[:, 0] = vals
        else:
            G = torch.zeros_like(F)
            for a in range(g.rl):
                cols = (base + a * g.rowpitch)[:, None] \
                    + torch.arange(g.rowpitch)[None, :]
                G[:, :g.rowpitch] += F[:, a:a + 1] * image[cols]
            F = G
    values = torch.where(ok, F[:, 0], torch.nan)
    return values, int((~ok).sum())


# ---------------------------------------------------------------------------
# the launch


class _Site(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong), ("s2", ctypes.c_longlong),
                ("rl", ctypes.c_int), ("n", ctypes.c_int),
                ("rr", ctypes.c_int), ("ccode", ctypes.c_int),
                ("dst", ctypes.c_int), ("dpitch", ctypes.c_int),
                ("drow", ctypes.c_int), ("dot", ctypes.c_int),
                ("estart", ctypes.c_int), ("pad", ctypes.c_int)]


class _Group(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in
                ("last", "off", "pitch", "rowpitch", "code", "rl")]


class _Step(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in StepPlan._fields]


class _Table(ctypes.Structure):
    _fields_ = [("d", ctypes.c_int), ("ngroups", ctypes.c_int),
                ("nsteps", ctypes.c_int), ("stage_bytes", ctypes.c_int),
                ("ring_off", ctypes.c_int), ("bar_off", ctypes.c_int),
                ("stage_total", ctypes.c_int), ("bulk", ctypes.c_int),
                ("early", ctypes.c_int), ("work_warps", ctypes.c_int),
                ("sites", _Site * MAX_SITES), ("groups", _Group * MAX_SITES),
                ("steps", _Step * MAX_SITES)]


class Launch(NamedTuple):
    """One prepared launch: the plan, the by-value table (or, on the
    device-memory route, the table tensor) and the tensors it points into."""
    plan: Plan
    table: object
    cores: tuple
    positions: torch.Tensor
    scratch_elems: int

    @property
    def route(self) -> str:
        return self.plan.describe()


@lru_cache(maxsize=1)
def _library():
    lib = build.load_kernel_library("tt_eval")
    for name in ("xerus_tt_eval_f32", "xerus_tt_eval_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    for name in ("xerus_tt_eval_generic_f32", "xerus_tt_eval_generic_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(cores: Sequence[torch.Tensor], positions: torch.Tensor) -> None:
    if not cores:
        raise ValueError("tt_eval_at_points: no cores")
    dev, dtype = cores[0].device, cores[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tt_eval_at_points: cores are {dtype}, need "
                        "float32 or float64")
    for k, c in enumerate(cores):
        if c.device != dev or c.dtype != dtype:
            raise ValueError(f"tt_eval_at_points: core {k} is {c.dtype} on "
                             f"{c.device}, core 0 {dtype} on {dev}")
        if c.dim() != 3:
            raise ValueError(f"tt_eval_at_points: core {k} must be an "
                             "(rl, n, rr) tensor")
        if k and c.shape[0] != cores[k - 1].shape[2]:
            raise ValueError(f"tt_eval_at_points: core {k} has "
                             f"{c.shape[0]} rows, core {k - 1} "
                             f"{cores[k - 1].shape[2]} columns")
    if positions.device != dev:
        raise ValueError(f"tt_eval_at_points: positions on "
                         f"{positions.device}, cores on {dev}")
    if positions.dtype != torch.int64:
        raise TypeError(f"tt_eval_at_points: positions are "
                        f"{positions.dtype}, need int64")
    if (positions.dim() != 2 or positions.shape[1] != len(cores)
            or not positions.is_contiguous()):
        raise ValueError(f"tt_eval_at_points: positions must be a "
                         f"contiguous (M, {len(cores)}) tensor, got "
                         f"{tuple(positions.shape)}")


def core_table(cores: Sequence[torch.Tensor]) -> List[Tuple[int, ...]]:
    """One row (address, stride 0, stride 1, stride 2, rl, n, rr) per core:
    element [a, i, b] lies ``a*s0 + i*s1 + b*s2`` elements past the
    address, whatever the core's layout, so no core is copied."""
    return [(c.data_ptr(), *c.stride(), *c.shape) for c in cores]


def plan_launch(cores: Sequence[torch.Tensor], positions: torch.Tensor,
                groups=None) -> Launch:
    """The hand-over: plan (cached by shapes and M) and table for checked
    inputs.  On the shared-memory route it touches no device memory; on the
    device-memory route it copies one small table to the card."""
    shapes = tuple(tuple(c.shape) for c in cores)
    M = positions.shape[0]
    device = cores[0].device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = tt_eval_plan(shapes, cores[0].element_size(), M, sms,
                        positions.data_ptr() % 16 == 0, groups)
    rows = core_table(cores)
    if plan.route == ROUTE_GENERIC:
        # from pinned memory, so that the copy queues behind earlier work
        # instead of making the host wait for it
        table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
        r = max(max(s[0], s[2]) for s in shapes)
        # ranks up to 32 keep the frontier in registers
        return Launch(plan, table, tuple(cores), positions,
                      2 * r * M if r > 32 else 0)
    t = _Table()
    t.d, t.ngroups, t.nsteps = len(cores), len(plan.groups), len(plan.steps)
    t.stage_bytes = plan.stage_bytes
    t.ring_off, t.bar_off = plan.ring_off, plan.bar_off
    t.stage_total, t.early = plan.stage_total, plan.early
    t.work_warps = plan.work_warps
    t.bulk = int(plan.positions == "bulk copies")
    for k, (row, s) in enumerate(zip(rows, plan.sites)):
        t.sites[k] = _Site(row[0], row[1], row[2], row[3], s.rl, s.n, s.rr,
                           s.ccode, s.dst, s.dpitch, s.drow, s.dot, s.estart,
                           0)
    for k, g in enumerate(plan.groups):
        t.groups[k] = _Group(g.last, g.off, g.pitch, g.rowpitch, g.code,
                             g.rl)
    for k, st in enumerate(plan.steps):
        t.steps[k] = _Step(*st)
    return Launch(plan, t, tuple(cores), positions, 0)


def launch_plan(launch: Launch, stamps: Optional[torch.Tensor] = None):
    """Launch K3 as prepared; returns (out, bad) on the card without
    reading ``bad`` (int32 counts, one per block, whose sum is the number
    of measurements with an index outside its site's mode size).
    ``stamps``, an int64 (blocks, 4) tensor on the card, takes each block's
    global-timer readings in ns (start, cores staged, tables built, warp 0
    done) on the shared-memory route: the only view of the kernel's phases,
    which CUDA events around the launch cannot separate."""
    plan, positions = launch.plan, launch.positions
    device, dtype = positions.device, launch.cores[0].dtype
    M = positions.shape[0]
    lib = _library()
    out = torch.empty((M,), dtype=dtype, device=device)
    suffix = "f32" if dtype == torch.float32 else "f64"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan.route == ROUTE_GENERIC:
            bad = torch.zeros((1,), dtype=torch.int32, device=device)
            scratch = torch.empty((max(launch.scratch_elems, 1),),
                                  dtype=dtype, device=device)
            fn = getattr(lib, "xerus_tt_eval_generic_" + suffix)
            rc = fn(launch.table.data_ptr(), positions.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), bad.data_ptr(),
                    len(launch.cores), max(max(c.shape[0], c.shape[2])
                                           for c in launch.cores),
                    M, plan.blocks, stream)
        else:
            # one count per block, written by the launch: nothing to zero
            bad = torch.empty((plan.blocks,), dtype=torch.int32,
                              device=device)
            fn = getattr(lib, "xerus_tt_eval_" + suffix)
            rc = fn(ctypes.addressof(launch.table), positions.data_ptr(),
                    out.data_ptr(), bad.data_ptr(), M, plan.R, plan.threads,
                    plan.blocks, plan.smem_bytes,
                    stamps.data_ptr() if stamps is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"tt_eval kernel launch failed: cudaError {rc} "
                           f"({plan.describe()})")
    tt_eval_at_points.launches += 1
    tt_eval_at_points.route = plan.describe()
    return out, bad


def _launch(cores: Sequence[torch.Tensor], positions: torch.Tensor):
    """Hand the cores over and launch K3 on checked CUDA inputs."""
    return launch_plan(plan_launch(cores, positions))


def tt_eval_at_points(cores: Sequence[torch.Tensor],
                      positions: torch.Tensor) -> torch.Tensor:
    """values[m] = TT[positions[m]] for cores (rl, n, rr) and positions
    (M, d) int64 on one device; returns (M,) in the cores' dtype.

    ``tt_eval_at_points.calls`` counts every call;
    ``tt_eval_at_points.launches`` counts the kernel launches, and only
    those; ``tt_eval_at_points.route`` describes the last launch's plan.
    An index outside its site's mode size raises ValueError on both
    routes: on the card after the launch (one read of the blocks' counts,
    under 1 KB, to the host), on the CPU before the plain version runs."""
    tt_eval_at_points.calls += 1
    _check(cores, positions)
    device = cores[0].device
    if device.type == "cpu":
        dims = torch.tensor([c.shape[1] for c in cores])
        if positions.numel() and bool(((positions < 0)
                                       | (positions >= dims)).any()):
            raise ValueError("tt_eval_at_points: positions lie outside the "
                             "mode sizes")
        return tt_eval_at_points_reference(cores, positions)
    if device.type != "cuda":
        raise RuntimeError(f"tt_eval_at_points: no kernel for device "
                           f"{device}")
    out, bad = _launch(cores, positions)
    n_bad = int(bad.cpu().sum())
    if n_bad:
        raise ValueError(f"tt_eval_at_points: {n_bad} of {out.shape[0]} "
                         f"positions lie outside the mode sizes")
    return out


def reset_counters() -> None:
    """Zero the call and launch counts."""
    tt_eval_at_points.calls = 0
    tt_eval_at_points.launches = 0
    tt_eval_at_points.route = None


reset_counters()
