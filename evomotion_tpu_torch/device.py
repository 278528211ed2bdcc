"""Device choice for the port's entry points.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``, as the CPU tests do. Asking for ``cuda`` where PyTorch
sees no card raises: nothing falls back to the CPU. On the card, f32
matmuls stay f32 (no TF32): the networks agree with the CPU and with the
JAX package's f32 reference.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on (default ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "evomotion_tpu_torch: device 'cuda' requested but torch.cuda."
            "is_available() is False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev
