"""The port's device rule: the card unless the caller asks for the CPU."""

import torch

__all__ = ['resolve_device']


def resolve_device(device=None) -> torch.device:
    """``None`` means ``'cuda'``; a CUDA request without CUDA raises.

    Never falls back to the CPU: a caller who wants the CPU passes
    ``device='cpu'`` (the tests do).
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "on the CPU.")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"Unsupported device: {dev}.")
    return dev
