"""Fused RMSNorm on the card: the forward (wrapper of ``csrc/rmsnorm.cu``) and
its gradient (``csrc/rmsnorm_bwd.cu``).

The forward replaces the TPU kernel ``src/repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``fused_rmsnorm``).  Bound on the H100: bytes (one
read and one write of each element, a few flops each: N 512 x d 4096 in bf16
is 2.5 us at 3.35 TB/s; at d <= 2048 the bound is under a microsecond, less
than a launch costs).  ``fwd_plan`` sizes it from the shape alone: a row to
a team of the fewest warps (up to 16) whose lanes hold its 16-byte vectors
(8 bf16 / 4 f32), up to 8 a lane, in registers between the sum of squares
and the write (x read once; bf16 packed), and w read into registers once a
CTA; at most one wave of CTAs striding over the rows, so a ragged row count
needs no padding copy; a programmatic dependent launch, so that its start
overlaps the previous kernel's end.  Rows that are not whole vectors
take one element a lane; rows too wide for registers a two-pass CTA.

The backward has no TPU counterpart (the JAX package differentiates its
plain rmsnorm); see ``fused_rmsnorm_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)
bwd_launches = 0  # the same, of the backward kernel

SMS = 132  # streaming multiprocessors of an H100 SXM, the card the plans size a wave for

# The forward's launch plan (``fwd_plan``), in the kernel's limits
FWD_NV = 8  # 16-byte vectors (or elements) of a row a lane holds in registers at most
FWD_TEAM_WARPS = 16  # warps of a row's team at most (512 threads: <= 128 registers a thread)
FWD_CTA = 128  # threads of a CTA of narrower teams
FWD_STREAM_THREADS = 1024  # the two-pass CTA of a row too wide for registers
THREADS_SM = 2048  # threads an SM holds
REGS_SM = 65536  # 32-bit registers of an SM

# The backward's launch plan (``bwd_plan``), in the kernel's limits
TILES = 256  # row tiles (CTAs and dw partials) at most
BWD_THREADS = 512  # threads of a CTA at most
BWD_STAGES = 4  # slots of a CTA's ring at most
BWD_RPS = 4  # rows a step at most (1, 2 or 4)
STEP_BYTES = 8192  # bytes of x a step aims at
SMEM_SMALL = 72 * 1024  # shared memory of a CTA that leaves the SM's L1 most of its room
SMEM_SHARED = 113 * 1024  # shared memory of a CTA when two share an H100 SM
SMEM_MAX = 227 * 1024  # shared memory a CTA can have on an H100


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in _build.DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"rmsnorm kernel needs contiguous x (..., {d}) and w ({d},), got {tuple(w.shape)}")
    if d == 0:
        raise ValueError("rmsnorm kernel needs d > 0")
    return d


def fwd_regs(nv: int, vector: bool) -> int:
    """The registers a thread of the forward's ``nv`` instantiation needs at
    most, as the plan counts them for its wave (``chip_smoke.py``'s build
    report holds ptxas's counts to it): x and w held (bf16 packed, two
    values a register), 10 registers a pair of 16-byte vectors or 2 a pair
    of elements, beside 40 (48 on the scalar path) of addresses and sums;
    64 on the two-pass path."""
    if nv == 0:
        return 64
    return 40 + 10 * nv if vector else 48 + 2 * nv


def fwd_plan(n: int, d: int, elem_size: int, vector: bool) -> tuple[int, int, int, int]:
    """(team_warps, threads, grid, nv) of the forward on n rows of d elements
    of ``elem_size`` bytes, from the shape alone.  A row's lanes are its
    16-byte vectors (``vector``) or its elements; a team of ``team_warps``
    warps (the fewest, a power of two up to FWD_TEAM_WARPS) holds them, nv
    a lane (a power of two up to FWD_NV); rows wider than that take the
    two-pass CTA (nv 0, FWD_STREAM_THREADS threads).  CTAs of FWD_CTA
    threads hold several teams; ``grid`` is at most one wave of them (by
    threads and ``fwd_regs`` on SMS SMs), striding over the rows."""
    lanes = d * elem_size // 16 if vector else d
    warps = 1
    while warps < FWD_TEAM_WARPS and lanes > FWD_NV * 32 * warps:
        warps *= 2
    if lanes > FWD_NV * 32 * warps:
        warps, nv, threads = FWD_STREAM_THREADS // 32, 0, FWD_STREAM_THREADS
    else:
        nv = 1 << (-(-lanes // (32 * warps)) - 1).bit_length()
        threads = max(FWD_CTA, 32 * warps)
    teams = threads // (32 * warps)
    per_sm = max(1, min(THREADS_SM // threads, REGS_SM // (threads * fwd_regs(nv, vector))))
    grid = max(1, min(-(-n // teams), SMS * per_sm))
    return warps, threads, grid, nv


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d), w: (d,), both CUDA, same dtype (f32 or bf16), contiguous."""
    global launches
    d = _check(x, w)
    n = x.numel() // d
    out = torch.empty_like(x)
    vector = all(t.data_ptr() % 16 == 0 for t in (x, w, out)) and d * x.element_size() % 16 == 0
    team_warps, threads, grid, nv = fwd_plan(n, d, x.element_size(), vector)
    fn = _build.function(
        "rmsnorm",
        "rmsnorm_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, eps, team_warps, threads, grid, nv,
        int(vector), _build.DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("rmsnorm", err)
    launches += 1
    return out


def bwd_plan(n: int, d: int, elem_size: int, vector: bool) -> tuple[int, int, int, int, int]:
    """(rows_per_tile, n_tiles, threads, rows_per_step, stages) of the
    backward on n rows of d elements of ``elem_size`` bytes, from the shape
    alone, so the bits of dw do not depend on the card.  At most TILES tiles
    of whole rows (TILES / 2 when a CTA needs a whole SM's shared memory: one
    wave); one 16-byte vector (``vector``) or element a thread per row up to
    256 of them, two above, in multiples of 32 threads up to BWD_THREADS; a
    step of 1, 2 or BWD_RPS rows, at least STEP_BYTES of x where it can (one
    barrier a step); ``stages`` slots of a step's rows of x and g in shared
    memory beside the d-float dw partial: as many as fit SMEM_SMALL, else
    SMEM_SHARED (two CTAs an SM), else one CTA an SM, at most BWD_STAGES and
    no more than the tile's steps.  ``stages`` is 0 for the scalar path (one
    row a step): rows that are not whole vectors, or wider than one slot."""
    if 4 * d > SMEM_MAX:
        raise ValueError(f"rmsnorm backward: d={d} leaves no room for the f32 dw partial")
    lanes = d * elem_size // 16 if vector else d
    threads = min(BWD_THREADS, max(32, -(-(lanes if lanes <= 256 else -(-lanes // 2)) // 32) * 32))
    want = -(-STEP_BYTES // (d * elem_size))  # rows of x in STEP_BYTES, rounded up
    rps = min(BWD_RPS, 1 << (want - 1).bit_length()) if vector else 1
    per_slot = 2 * rps * d * elem_size + 8  # a step's x and g rows and the slot's barrier
    tiles = TILES // 2 if vector and 4 * d + 2 * per_slot > SMEM_SHARED else TILES
    rows_per_tile = max(1, -(-n // tiles))
    n_tiles = -(-n // rows_per_tile)
    steps = -(-rows_per_tile // rps)
    stages = 0
    if vector:
        for budget in (SMEM_SMALL, SMEM_SHARED, SMEM_MAX):
            stages = min(BWD_STAGES, steps, max(0, budget - 4 * d) // per_slot)
            if stages >= min(2, steps):
                break
        if stages == 0:  # too wide for a slot: the scalar path, a row a step
            rps = 1
    return rows_per_tile, n_tiles, threads, rps, stages


def fused_rmsnorm_bwd(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``fused_rmsnorm(x, w, eps)`` given ``g``, the gradient of its
    output (same shape and dtype as x, contiguous).  No TPU counterpart.

    Bound on the H100: bytes (x and g read, dx written).  A CTA per tile of
    rows (``bwd_plan``) streams its rows into a ring in shared memory, so x
    and g leave device memory once, writes dx and keeps the tile's f32 dw
    partial in shared memory; a second launch sums the partials (an f32
    scratch of n_tiles x d from ``torch.empty``) column by column.  No float
    atomics, so two runs give equal bits."""
    global bwd_launches
    d = _check(x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"rmsnorm backward needs a contiguous g like x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    n = x.numel() // d
    vector = all(t.data_ptr() % 16 == 0 for t in (x, w, g)) and d * x.element_size() % 16 == 0
    rows_per_tile, n_tiles, threads, rps, stages = bwd_plan(n, d, x.element_size(), vector)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((n_tiles, d), dtype=torch.float32, device=x.device)
    fn = _build.function(
        "rmsnorm_bwd",
        "rmsnorm_bwd_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
        n, d, rows_per_tile, threads, rps, stages, eps, _build.DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("rmsnorm_bwd", err)
    bwd_launches += 1
    return dx, dw
