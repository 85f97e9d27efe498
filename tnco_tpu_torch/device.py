"""The port's device rule: the card unless the caller asks for the CPU."""

import subprocess

import torch

__all__ = ['resolve_device', 'card_info']


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


def card_info(dev: torch.device) -> dict:
    """``{'name', 'power_limit'}`` of the card as ``nvidia-smi
    --query-gpu=name,power.limit`` prints them (the first card), or
    ``{'name': 'cpu'}`` for the CPU."""
    if dev.type == 'cpu':
        return {'name': 'cpu'}
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.rsplit(',', 1))
    return {'name': name, 'power_limit': limit}
