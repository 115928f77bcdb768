"""Where the port computes: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Entry points default to ``"cuda"``.  With no usable GPU that raises: the
    port never carries on quietly on the CPU.  ``device="cpu"`` is the
    explicit request the tests make.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
