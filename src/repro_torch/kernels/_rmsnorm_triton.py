"""The Triton RMSNorm kernels.  Imported only by ``rmsnorm.rmsnorm`` and
``rmsnorm.rmsnorm_bwd`` when they launch on a CUDA tensor: this module
imports ``triton`` at the top, and hosts without a card have none."""
from __future__ import annotations

import os
from pathlib import Path

# keep Triton's compile cache inside the checkout, beside the CUDA builds
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(Path(__file__).resolve().parents[3] / ".torch_ext_build" / "triton"))

import torch  # noqa: E402
import triton  # noqa: E402
import triton.language as tl  # noqa: E402

# programs of the backward pass, each summing its rows' share of dscale into
# one partial row: fixed, so the order of the sums (and the result) depends
# on the shape alone
BWD_PROGRAMS = 512
# the partials' column sum: a tile of SUM_ROWS partial rows x SUM_COLS columns a step
SUM_ROWS, SUM_COLS = 64, 64


@triton.jit
def _rmsnorm_kernel(x_ptr, scale_ptr, out_ptr, rstd_ptr, n_cols, eps, BLOCK: tl.constexpr,
                    STORE_RSTD: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    s = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    r = tl.rsqrt(var + eps)
    y = x * r * (1.0 + s)
    tl.store(out_ptr + row * n_cols + cols, y.to(out_ptr.dtype.element_ty), mask=mask)
    if STORE_RSTD:
        tl.store(rstd_ptr + row, r)


@triton.jit
def _rmsnorm_bwd_kernel(x_ptr, scale_ptr, g_ptr, rstd_ptr, dx_ptr, part_ptr, n_rows, n_cols,
                        rows_per_prog, BLOCK: tl.constexpr):
    """dx = r (g o w) - x r^3 mean(g o w o x) per row, w = 1 + scale; the
    program's share of dscale = sum over its rows of g o x r, one partial row."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    w = 1.0 + tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for i in range(0, rows_per_prog):
        row = pid * rows_per_prog + i
        live = row < n_rows
        m = mask & live
        off = row.to(tl.int64) * n_cols + cols
        r = tl.load(rstd_ptr + row, mask=live, other=0.0)
        x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + off, mask=m, other=0.0).to(tl.float32)
        gw = g * w
        c = tl.sum(gw * x, axis=0) / n_cols
        dx = r * gw - x * (r * r * r) * c
        tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m)
        acc += g * x * r
    tl.store(part_ptr + pid.to(tl.int64) * n_cols + cols, acc, mask=mask)


@triton.jit
def _rmsnorm_dscale_kernel(part_ptr, out_ptr, n_parts, n_cols, ROWS: tl.constexpr,
                           COLS: tl.constexpr):
    """dscale[cols] = the sum of the partial rows, ROWS of them a step."""
    cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
    cmask = cols < n_cols
    acc = tl.zeros([ROWS, COLS], dtype=tl.float32)
    for p0 in range(0, n_parts, ROWS):
        rows = p0 + tl.arange(0, ROWS)
        m = (rows[:, None] < n_parts) & cmask[None, :]
        acc += tl.load(part_ptr + rows[:, None].to(tl.int64) * n_cols + cols[None, :], mask=m,
                       other=0.0)
    tl.store(out_ptr + cols, tl.sum(acc, axis=0).to(out_ptr.dtype.element_ty), mask=cmask)


def _warps(block: int) -> int:
    return min(max(block // 256, 1), 16)


def launch(x2: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, eps: float,
           rstd: torch.Tensor | None = None) -> None:
    """x2, out (rows, D) contiguous; one program per row.  With ``rstd``
    (rows,) fp32, each row's 1/rms is stored there too, for the backward."""
    rows, d = x2.shape
    block = triton.next_power_of_2(d)
    _rmsnorm_kernel[(rows,)](x2, scale, out, out if rstd is None else rstd, d, eps,
                             BLOCK=block, STORE_RSTD=rstd is not None, num_warps=_warps(block))


def launch_bwd(x2: torch.Tensor, scale: torch.Tensor, g2: torch.Tensor, rstd: torch.Tensor,
               dx: torch.Tensor, dscale: torch.Tensor) -> None:
    """x2, g2, dx (rows, D) contiguous, rstd (rows,) fp32, dscale (D,): the
    row pass writes dx and one fp32 partial row of dscale per program, the
    second pass sums the partials (no atomics: the result repeats)."""
    rows, d = x2.shape
    block = triton.next_power_of_2(d)
    per = triton.cdiv(rows, min(rows, BWD_PROGRAMS))
    n_prog = triton.cdiv(rows, per)
    part = torch.empty((n_prog, d), dtype=torch.float32, device=x2.device)
    _rmsnorm_bwd_kernel[(n_prog,)](x2, scale, g2, rstd, dx, part, rows, d, per, BLOCK=block,
                                   num_warps=_warps(block))
    _rmsnorm_dscale_kernel[(triton.cdiv(d, SUM_COLS),)](part, dscale, n_prog, d, ROWS=SUM_ROWS,
                                                        COLS=SUM_COLS, num_warps=4)
