"""Time-major ConvTranspose1d for the DualPathRNN tail: kernel K3.

Counterpart of ``rtfs_tpu/ops/convt_tm.py``, forward and backward. It
reads the SRU stack's native time-major ``(L, C_in, B)`` output and writes
``(L + k - 1, C_out, B)``:

  out[t] = sum_j 1[0 <= t-j < L] x[t-j] @ W[j]^T

with W stored ``(k, C_out, C_in)`` (not flipped), stride 1, padding 0. The
bias is added by the caller. CUDA kernels ``csrc/convt_tm.cu:
convt1d_ola_tm_fwd`` (W resident in shared memory, a ring of x rows, the
product on the tensor cores in 3xTF32) and ``..._bwd`` (dx with W resident
in shared memory and a ring of g rows, dW as a split-K product whose
partials are summed in a fixed order). Any width runs: channels wider than
a block holds are split over the grid (``fwd_geometry``,
``bwd_geometry``), the partial sums of a split reduction added in a fixed
order. When autograd records, the op runs
through a ``torch.autograd.Function`` whose backward is the kernel. On a
CPU tensor the plain versions below run, forward and backward.

The op also takes bf16 storage: the forward (``convt1d_ola_tm_fwd_bf16``:
x, W and out bf16, the products bf16 on the tensor cores into float32
sums, the sum rounded to bf16 once, after the whole reduction, as the
Pallas kernel's float32 dot result is; its blocks walk runs of passes
over column tiles, ``fwd_bf16_geometry``) and the backward
(``convt1d_ola_tm_bwd_bf16``: g, x and W in, dx and dW out bf16, both
products bf16 on the tensor cores into float32 sums and each sum rounded
once, as the Pallas VJP's dx dot and dW scratch are): one kernel walks a
window of g rows over l for a tile of 16 batch columns and takes dx and
dW from it (``bwd_bf16_geometry``).
"""

from __future__ import annotations

import functools

import torch

from . import kernel_lib
from .sru_fused import arithmetic_dtype


def convt1d_ola_tm_plain(x_tm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shifted-sum form: one (C_out x C_in) product per tap. In bf16
    storage the sums run in float32 on the widened values and are rounded
    once at the end."""
    dt = x_tm.dtype
    x_tm, w = x_tm.to(arithmetic_dtype(dt)), w.to(arithmetic_dtype(dt))
    length, _, bsz = x_tm.shape
    k, c_out, _ = w.shape
    out = x_tm.new_zeros(length + k - 1, c_out, bsz)
    for j in range(k):
        out[j:j + length] += torch.einsum("oi,lib->lob", w[j], x_tm)
    return out.to(dt)


def convt1d_ola_tm_bwd_plain(g: torch.Tensor, x_tm: torch.Tensor,
                             w: torch.Tensor):
    """K3 backward's plain version, tap by tap: dx[l] = sum_j W[j]^T g[l+j]
    and dW[j] = sum_{l, b} g[l+j] x[l]^T. Returns (dx, dw). In bf16
    storage g is taken in x's dtype, as the Pallas VJP casts it, the sums
    run in float32 on the widened values and each is rounded once."""
    dt = x_tm.dtype
    g, x_tm, w = (t.to(dt).to(arithmetic_dtype(dt)) for t in (g, x_tm, w))
    length = x_tm.shape[0]
    dx = torch.zeros_like(x_tm)
    dw = torch.empty_like(w)
    for j in range(w.shape[0]):
        g_j = g[j:j + length]
        dx += torch.einsum("oi,lob->lib", w[j], g_j)
        dw[j] = torch.einsum("lob,lib->oi", g_j, x_tm)
    return dx.to(dt), dw.to(dt)


def _check(x_tm, w):
    if x_tm.shape[1] != w.shape[2]:
        raise ValueError(f"convt1d_ola_tm: x {tuple(x_tm.shape)} vs w "
                         f"{tuple(w.shape)}")


# K3 forward's geometry, the constants of csrc/convt_tm.cu: output
# channels a block (``kMaxOut``, four m16 tiles; a wider C_out is split
# over the grid), blocks of 16 batch columns (``kFwdCols``, also an x
# row's stride in shared memory) and 8 output steps a pass (``kFwdPass``)
MAX_OUT = 64
FWD_COLS = 16
FWD_PASS = 8


def fwd_smem(k: int, c_in: int, c_out: int) -> int:
    """K3 forward's dynamic shared memory in bytes for a block of ``c_in``
    input and ``c_out`` output channels (``fwd_smem_floats`` in the
    source): W_flat, C_out padded to 16 rows of k * C_in' + 4 floats with
    C_in' = C_in padded to 8, and the ring of k + 2 FWD_PASS - 1 x rows."""
    c_pad = -(-c_in // 8) * 8
    return 4 * (-(-c_out // 16) * 16 * (k * c_pad + 4)
                + (k + 2 * FWD_PASS - 1) * c_pad * FWD_COLS)


def bf16_vec(n: int) -> int:
    """The bf16 K3 forward's values a copy along a row of ``n`` (B for x
    and out, C_in for W): the largest of 8, 4, 2 dividing n (16-, 8-,
    4-byte accesses), else 1 (x's rows then go as words, realigned)."""
    return next((w for w in (8, 4, 2) if n % w == 0), 1)


def _slices(n: int, fits, align: int) -> int:
    """The widest slice of ``n`` channels for which ``fits(width)`` holds:
    all of ``n``, else the fewest equal slices, each a multiple of
    ``align``. Raises ValueError where not even ``align`` channels fit."""
    if fits(n):
        return n
    for parts in range(2, -(-n // align) + 1):
        width = -(-(-(-n // parts)) // align) * align
        if fits(width):
            return width
    raise ValueError(f"convt1d_ola_tm: {align} channels do not fit a block")


@functools.lru_cache(maxsize=None)
def fwd_geometry(length: int, c_in: int, c_out: int, k: int,
                 bsz: int) -> dict:
    """K3 forward's launch geometry, as ``convt1d_ola_tm_fwd`` launches it:
    the input channels split into ``in_slices`` of ``ci_slice`` (all of
    C_in where W_flat and the ring fit one block's shared memory, else the
    fewest equal slices, multiples of 8, that do), the output channels into
    ``out_slices`` blocks of at most MAX_OUT; the blocks (column tiles x
    runs of ``steps`` consecutive output steps, a multiple of
    ``FWD_PASS``, x the slices, about one wave over the card's SMs) and
    their dynamic shared memory in bytes. With more than one input slice
    each writes a partial of out (``part`` floats each), summed in order.
    The bf16 kernel's geometry is ``fwd_bf16_geometry``."""
    t_out = length + k - 1
    co_blk = min(c_out, MAX_OUT)
    ci_slice = _slices(c_in, lambda w: fwd_smem(k, w, co_blk)
                       <= kernel_lib.SMEM_PER_BLOCK, 8)
    in_slices, out_slices = -(-c_in // ci_slice), -(-c_out // MAX_OUT)
    col_tiles = -(-bsz // FWD_COLS)
    # one block an SM
    runs = max(1, min(t_out, kernel_lib.SMS // (col_tiles * in_slices
                                                * out_slices)))
    steps = -(-t_out // runs)
    steps = -(-steps // FWD_PASS) * FWD_PASS
    return {
        "grid": (col_tiles, -(-t_out // steps), in_slices * out_slices),
        "steps": steps, "ci_slice": ci_slice, "in_slices": in_slices,
        "out_slices": out_slices, "smem": fwd_smem(k, ci_slice, co_blk),
        "part": t_out * c_out * bsz,
        "vec_x": 4 if bsz % 4 == 0 else 1,
        "vec_w": 4 if c_in % 4 == 0 else 1,
    }


# the bf16 K3 forward (``convt1d_tm_fwd_bf16_kernel``), ``kFwd16Pass``,
# ``kFwd16Stages``, ``kFwd16Cols``, ``kFwd16Stage`` in
# csrc/convt_tm.cu: output steps a pass (an item of work), passes in the
# ring of x rows, the widest column tile, a warp's staging row (bf16)
FWD16_PASS = 8
FWD16_STAGES = 3
FWD16_COLS = 32
FWD16_STAGE = 24
# ``kFwd16MinWarps`` / ``kFwd16SoloWarps``: the warps a block at least
# where two blocks share an SM / where a block holds it alone (past the
# tile's, a warp only copies)
FWD16_MIN_WARPS = 4
FWD16_SOLO_WARPS = 8
# (columns, output channels) of a block, in the order the geometry tries
# them: the widest tile first, then fewer output channels a block
FWD16_TILES = ((32, 64), (16, 64), (32, 32), (16, 32), (32, 16), (16, 16))


def fwd_bf16_smem(k: int, c_in: int, mb: int, nc: int) -> int:
    """The bf16 K3 forward's dynamic shared memory in bytes
    (``fwd_bf16_smem_bytes``) at ``c_in`` input channels, ``mb`` output
    channels and ``nc`` columns a block: W_flat (mb rows of k C_in' + 8
    bf16, C_in' = C_in padded to 16), the ring of k - 1 + FWD16_STAGES
    FWD16_PASS x rows (C_in' rows of nc + 8) and each warp's 16 x
    FWD16_STAGE staging tile."""
    cp = -(-c_in // 16) * 16
    return 2 * (mb * (k * cp + 8)
                + (k - 1 + FWD16_STAGES * FWD16_PASS) * cp * (nc + 8)
                + (mb // 16) * (nc // 16) * 16 * FWD16_STAGE)


@functools.lru_cache(maxsize=None)
def fwd_bf16_geometry(length: int, c_in: int, c_out: int, k: int,
                      bsz: int, nc: int = 0, mb: int = 0) -> dict:
    """The bf16 K3 forward's launch geometry, as ``convt1d_ola_tm_fwd_bf16``
    launches it (``convt1d_tm_fwd_bf16_kernel``).

    A block holds W_flat's rows of ``mb`` output channels and walks items,
    an item FWD16_PASS output steps of one tile of ``nc`` columns:
    ``items`` = ceil(B / nc) tiles x ceil((L + k - 1) / FWD16_PASS)
    ``passes`` a grid row, a grid row (z) a slice of ``ci_slice`` input
    channels (all of C_in where W_flat and the ring fit, else the fewest
    equal slices, multiples of 16, that do) and a block of mb output
    channels. (nc, mb) is the first of FWD16_TILES whose items over the
    grid rows fill the card's SMs (else the one with the most), and each
    row's items are split into ``blocks`` equal runs in tile-major order,
    as many as fit the card at once (``per_sm`` blocks an SM by shared
    memory and threads) or the items, whichever is fewer: at the bs-8
    sites 32-column tiles of all 64 channels, 132 blocks of ~2 passes; at
    bs 4 16 columns; at bs 1 16 columns of 16 channels, 64 x 4 blocks of
    one pass. ``vec_x`` / ``vec_w`` the values a copy of x (and a store of
    out) and of W (``bf16_vec``). ``nc`` and ``mb`` force the tile (a
    variant)."""
    limit = kernel_lib.SMEM_PER_BLOCK
    t_out = length + k - 1
    passes = -(-t_out // FWD16_PASS)
    best = None
    for tnc, tmb in ((nc, mb),) if nc else FWD16_TILES:
        try:
            ci_slice = _slices(c_in, lambda w: fwd_bf16_smem(
                k, w, tmb, tnc) <= limit, 16)
        except ValueError:
            continue
        in_slices, out_slices = -(-c_in // ci_slice), -(-c_out // tmb)
        items = -(-bsz // tnc) * passes
        rows = in_slices * out_slices
        cand = (tnc, tmb, ci_slice, in_slices, out_slices, items, rows)
        if best is None or items * rows > best[5] * best[6]:
            best = cand
        if items * rows >= kernel_lib.SMS:
            best = cand
            break
    if best is None:
        raise ValueError("convt1d_ola_tm: 16 channels do not fit a block")
    tnc, tmb, ci_slice, in_slices, out_slices, items, rows = best
    smem = fwd_bf16_smem(k, ci_slice, tmb, tnc)
    solo = 2 * (smem + 1024) > kernel_lib.SMEM_PER_SM
    threads = 32 * max(FWD16_SOLO_WARPS if solo else FWD16_MIN_WARPS,
                       (tmb // 16) * (tnc // 16))
    per_sm = max(1, min(kernel_lib.SMEM_PER_SM // (smem + 1024),
                        2048 // threads))
    blocks = min(items, -(-kernel_lib.SMS * per_sm // rows))
    return {
        "nc": tnc, "mb": tmb, "grid": (blocks, 1, rows), "blocks": blocks,
        "items": items, "passes": passes, "threads": threads,
        "per_sm": per_sm, "ci_slice": ci_slice, "in_slices": in_slices,
        "out_slices": out_slices, "smem": smem,
        "part": t_out * c_out * bsz,
        "vec_x": bf16_vec(bsz), "vec_w": bf16_vec(c_in),
    }


def _forward(x_tm, w):
    if x_tm.device.type == "cpu":
        return convt1d_ola_tm_plain(x_tm, w)
    dt = kernel_lib.check_cuda("convt1d_ola_tm", x_tm, w,
                               dtypes=(torch.float32, torch.bfloat16))
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    if min(x_tm.shape) == 0 or k == 0 or c_out == 0:
        raise ValueError(f"convt1d_ola_tm: unsupported shape x "
                         f"{tuple(x_tm.shape)}, w {tuple(w.shape)}")
    bf16 = dt == torch.bfloat16
    if bf16:
        x_tm, w = kernel_lib.aligned16(x_tm), kernel_lib.aligned16(w)
    if bf16:
        geo = fwd_bf16_geometry(length, c_in, c_out, k, bsz)
        tile = (geo["nc"], geo["mb"], geo["ci_slice"], geo["blocks"])
    else:
        geo = fwd_geometry(length, c_in, c_out, k, bsz)
        tile = (geo["steps"], geo["ci_slice"])
    out = torch.empty(length + k - 1, c_out, bsz, device=x_tm.device,
                      dtype=dt)
    part = (torch.empty(geo["in_slices"], geo["part"], device=x_tm.device)
            if geo["in_slices"] > 1 else None)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_fwd_bf16" if bf16 else "convt1d_ola_tm_fwd",
        x_tm.device,
        x_tm.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        length, c_in, c_out, k, bsz, *tile,
    )
    return out


# K3 backward's geometry, the constants of csrc/convt_tm.cu: dx blocks of
# 32 batch columns (``kDxCols``) in 4 tap groups (``kDxGroups``) and 64
# input channels (``kMaxIn``, also W's row stride in shared memory; a
# wider C_in is split over the grid); dW tiles of 128 x 64 (``kWgRows`` x
# ``kMaxIn``), stages of 32 columns (``kWgCols``)
DX_COLS = 32
DX_GROUPS = 4
MAX_IN = 64
WGRAD_ROWS = 128
WGRAD_COLS = 32


def dx_smem(k: int, c_out: int) -> int:
    """K3 dx's dynamic shared memory in bytes for a block of ``c_out``
    output channels (``dx_smem_floats`` in the source): W's slice, the ring
    of k + 1 g rows, the tap groups' exchange tiles."""
    return 4 * (k * c_out * MAX_IN + (k + 1) * c_out * DX_COLS
                + (DX_GROUPS - 1) * MAX_IN * DX_COLS)


@functools.lru_cache(maxsize=None)
def bwd_geometry(length: int, c_in: int, c_out: int, k: int,
                 bsz: int) -> dict:
    """K3 backward's launch geometry, as ``convt1d_ola_tm_bwd`` launches it:
    the dx blocks (column tiles x runs of ``steps`` consecutive steps x
    ``in_slices`` of MAX_IN input channels x ``out_slices`` of
    ``co_slice`` output channels, about one wave over the card's SMs;
    ``co_slice`` all of C_out where W's slice and the ring fit one block,
    else the fewest equal slices that do), their dynamic shared memory in
    bytes, and the dW split-K over the L*B columns (``cols`` a chunk, one
    partial each). With more than one output slice each dx block writes a
    partial of dx, summed in order."""
    co_slice = _slices(c_out, lambda w: dx_smem(k, w)
                       <= kernel_lib.SMEM_PER_BLOCK, 1)
    in_slices, out_slices = -(-c_in // MAX_IN), -(-c_out // co_slice)
    col_tiles = -(-bsz // DX_COLS)
    # one block an SM
    runs = max(1, min(length, kernel_lib.SMS // (col_tiles * in_slices
                                                 * out_slices)))
    steps = -(-length // runs)
    wgrad_tiles = -(-k * c_out // WGRAD_ROWS) * -(-c_in // MAX_IN)
    cols, chunks = kernel_lib.split_k(length * bsz, wgrad_tiles, WGRAD_COLS)
    return {
        "dx_grid": (col_tiles, -(-length // steps), in_slices * out_slices),
        "steps": steps, "co_slice": co_slice, "in_slices": in_slices,
        "out_slices": out_slices, "dx_smem": dx_smem(k, co_slice),
        "wgrad_grid": (-(-c_in // MAX_IN), -(-k * c_out // WGRAD_ROWS),
                       chunks),
        "cols": cols, "chunks": chunks,
    }


# K3's bf16 backward, ``kDwTaps``, ``kDwOut``, ``kDwIn``, ``kDwPass``,
# ``kDwStages``, ``kDwWRow`` and ``kDwDxRow`` in csrc/convt_tm.cu: taps,
# output and input channels a block, l steps a pass, passes in its ring,
# W's rows and the dx tiles' rows in shared memory (bf16)
DW16_TAPS = 8
DW16_OUT = 64
DW16_IN = 32
DW16_PASS = 8
DW16_STAGES = 3
DW16_THREADS = 512
DW16_WROW = DW16_IN + 8
DW16_DXROW = 24


def bwd_bf16_smem() -> int:
    """K3's bf16 backward kernel's dynamic shared memory in bytes
    (``bwd_bf16_smem_bytes``): its ring of DW16_STAGES passes of g rows
    (DW16_OUT channels, and the window's DW16_TAPS - 1 rows more) and of
    x rows (DW16_IN channels), FWD_COLS bf16 columns each, W's DW16_TAPS
    DW16_OUT rows of DW16_WROW and each warp's 16 rows of dx of
    DW16_DXROW."""
    return 2 * (FWD_COLS * ((DW16_STAGES * DW16_PASS + DW16_TAPS - 1)
                            * DW16_OUT + DW16_STAGES * DW16_PASS * DW16_IN)
                + DW16_TAPS * DW16_OUT * DW16_WROW
                + DW16_THREADS // 32 * 16 * DW16_DXROW)


@functools.lru_cache(maxsize=None)
def bwd_bf16_geometry(length: int, c_in: int, c_out: int, k: int,
                      bsz: int) -> dict:
    """K3's bf16 backward geometry, as ``convt1d_ola_tm_bwd_bf16`` launches
    it (``convt1d_tm_bwd_bf16_kernel``): blocks of DW16_TAPS taps x
    DW16_OUT output x DW16_IN input channels (``grid`` (input tiles, tap
    tiles x output tiles, chunks)), each over one tile of 16 batch columns
    and a run of ``lsteps`` steps l, about one block an SM. Each block
    writes one float32 partial of dW (``chunks`` of them, summed in order)
    and its dx rows; where K or C_out takes more than one grid row
    (``dx_slices`` > 1), each row writes a float32 partial of dx
    (``dx_part`` values) instead, summed in order."""
    tiles_y = -(-k // DW16_TAPS) * -(-c_out // DW16_OUT)
    tiles = -(-c_in // DW16_IN) * tiles_y
    col_tiles = -(-bsz // 16)
    runs = max(1, min(length, kernel_lib.SMS // (tiles * col_tiles)))
    lsteps = -(-length // runs)
    chunks = col_tiles * -(-length // lsteps)
    return {"lsteps": lsteps, "chunks": chunks,
            "grid": (-(-c_in // DW16_IN), tiles_y, chunks),
            "dx_slices": tiles_y, "dx_part": length * c_in * bsz,
            "smem": bwd_bf16_smem()}


def _backward_bf16(g, x_tm, w):
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    geo = bwd_bf16_geometry(length, c_in, c_out, k, bsz)
    dev = x_tm.device
    g, x_tm, w = (kernel_lib.aligned16(t) for t in (g, x_tm, w))
    dx = torch.empty_like(x_tm)
    dw = torch.empty_like(w)
    dw_part = torch.empty(geo["chunks"], k, c_out, c_in, device=dev)
    dx_part = (torch.empty(geo["dx_slices"], geo["dx_part"], device=dev)
               if geo["dx_slices"] > 1 else None)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_bwd_bf16", dev,
        g.data_ptr(), w.data_ptr(), x_tm.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), dw_part.data_ptr(),
        None if dx_part is None else dx_part.data_ptr(),
        length, c_in, c_out, k, bsz, geo["lsteps"],
    )
    return dx, dw


def _backward(g, x_tm, w):
    if g.device.type == "cpu":
        return convt1d_ola_tm_bwd_plain(g, x_tm, w)
    dt = kernel_lib.check_cuda("convt1d_ola_tm backward", g, x_tm, w,
                               dtypes=(torch.float32, torch.bfloat16))
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    if min(x_tm.shape) == 0 or k == 0 or c_out == 0:
        raise ValueError(f"convt1d_ola_tm backward: unsupported shape x "
                         f"{tuple(x_tm.shape)}, w {tuple(w.shape)}")
    if dt == torch.bfloat16:
        return _backward_bf16(g, x_tm, w)
    geo = bwd_geometry(length, c_in, c_out, k, bsz)
    dev = x_tm.device
    dx = torch.empty_like(x_tm)
    dw = torch.empty_like(w)
    dw_part = torch.empty(geo["chunks"], k, c_out, c_in, device=dev)
    dx_part = (torch.empty(geo["out_slices"], *x_tm.shape, device=dev)
               if geo["out_slices"] > 1 else None)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_bwd", dev,
        g.data_ptr(), w.data_ptr(), x_tm.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), dw_part.data_ptr(),
        None if dx_part is None else dx_part.data_ptr(),
        length, c_in, c_out, k, bsz, geo["steps"], geo["cols"],
        geo["co_slice"],
    )
    return dx, dw


class _ConvTranspose(torch.autograd.Function):
    """K3 with its backward (``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x_tm, w):
        ctx.save_for_backward(x_tm, w)
        return _forward(x_tm, w)

    @staticmethod
    def backward(ctx, g):
        x_tm, w = ctx.saved_tensors
        return _backward(g.contiguous(), x_tm, w)


def convt1d_ola_tm(x_tm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose1d (stride 1) on time-major data.

    Args:
      x_tm: (L, C_in, B).
      w: (k, C_out, C_in); from a torch ``(C_in, C_out, k)`` weight,
        ``w.permute(2, 1, 0)``.

    Returns:
      (L + k - 1, C_out, B).
    """
    _check(x_tm, w)
    if torch.is_grad_enabled() and (x_tm.requires_grad or w.requires_grad):
        return _ConvTranspose.apply(x_tm, w)
    return _forward(x_tm, w)
