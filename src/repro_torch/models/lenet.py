"""LeNet-style MNIST classifier (the paper's Katib model: "docker.io/
liuhougangxa/tf-estimator-mnist uses LeNet"), counterpart of
``repro.models.lenet``, as plain functions over a dict of tensors.

Layout convention, chosen so both packages eat the same arrays and the
reference's weights carry across with one permute:

- ``apply`` takes the reference's NHWC images ``(B,28,28,1)`` (numpy or a
  tensor) and permutes to NCHW inside;
- conv weights are OIHW (the reference's are HWIO: ``transplant_lenet``
  permutes them); its ``SAME`` 5x5 is ``padding=2``, its 2x2
  ``reduce_window`` max is ``max_pool2d(2, 2)``;
- the reference flattens the pooled map in NHWC order, so ``apply`` permutes
  ``(B,C,7,7)`` back to ``(B,7,7,C)`` before the reshape, and ``fc1.w``
  carries across unpermuted;
- fc weights keep the reference's ``(in, out)`` layout (``x @ w``).

No TPU kernel is on this path, in the reference either: ``F.conv2d``,
``F.max_pool2d`` and ``@`` are the counterparts of
``lax.conv_general_dilated``, ``reduce_window`` and ``@``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .modules import dense_init, require_device


def init_params(generator: torch.Generator, *, width: int = 16, device="cuda") -> dict:
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``: one CPU generator gives the same init on the host
    and on the card.  The port's own init, never compared with the
    reference's ``truncated_normal`` draw (parity goes through
    ``transplant_lenet``)."""
    dev = require_device(device)
    gd = generator.device

    def w(shape, fan_in=None):
        return dense_init(shape, generator=generator, fan_in=fan_in, device=gd).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "conv1": {"w": w((width, 1, 5, 5), fan_in=25), "b": zeros(width)},
        "conv2": {"w": w((width * 2, width, 5, 5), fan_in=25 * width), "b": zeros(width * 2)},
        "fc1": {"w": w((7 * 7 * width * 2, 128)), "b": zeros(128)},
        "fc2": {"w": w((128, 10)), "b": zeros(10)},
    }


def apply(params: dict, images) -> torch.Tensor:
    """images: (B,28,28,1) NHWC, numpy or tensor -> logits (B,10)."""
    w1 = params["conv1"]["w"]
    x = torch.as_tensor(images, dtype=w1.dtype, device=w1.device).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, w1, params["conv1"]["b"], padding=2))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(F.conv2d(x, params["conv2"]["w"], params["conv2"]["b"], padding=2))
    x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC flatten order
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def loss_fn(params: dict, batch: dict):
    """Mean cross-entropy and accuracy: ``(loss, {"loss", "accuracy"})``."""
    logits = apply(params, batch["image"])
    labels = torch.as_tensor(batch["label"], device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}
