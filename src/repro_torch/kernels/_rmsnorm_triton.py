"""The Triton RMSNorm kernel.  Imported only by ``rmsnorm.rmsnorm`` when it
launches on a CUDA tensor: this module imports ``triton`` at the top, and
hosts without a card have none."""
from __future__ import annotations

import os
from pathlib import Path

# keep Triton's compile cache inside the checkout, beside the CUDA builds
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(Path(__file__).resolve().parents[3] / ".torch_ext_build" / "triton"))

import torch  # noqa: E402
import triton  # noqa: E402
import triton.language as tl  # noqa: E402


@triton.jit
def _rmsnorm_kernel(x_ptr, scale_ptr, out_ptr, n_cols, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    s = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(var + eps) * (1.0 + s)
    tl.store(out_ptr + row * n_cols + cols, y.to(out_ptr.dtype.element_ty), mask=mask)


def launch(x2: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, eps: float) -> None:
    """x2, out (rows, D) contiguous; one program per row."""
    rows, d = x2.shape
    block = triton.next_power_of_2(d)
    num_warps = min(max(block // 256, 1), 16)
    _rmsnorm_kernel[(rows,)](x2, scale, out, d, eps, BLOCK=block, num_warps=num_warps)
