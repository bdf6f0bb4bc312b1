"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the default
    everywhere) raises when no card is present: the CPU runs only when the
    caller asks for it, so a missing card can never silently turn a GPU
    run into a CPU one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu' ('meta' for shapes alone)")
    return dev
