"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and go through :func:`resolve_device`,
which raises when CUDA is asked for and absent: a run meant for the card
never quietly lands on the CPU. Tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate ``device`` and pin the float32 numerics the reference uses.

    TF32 is switched off for both matmuls and cuDNN: the JAX package's
    'f32' policy computes in true float32, and the parity tests hold the
    port to it.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device} is neither cuda nor cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
