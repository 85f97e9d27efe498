"""Hyper-cache recompute of the lane-major batch (from
``tnco_tpu/kernels/sa_batched.py:259``)."""

from tnco_tpu_torch.kernels.gather import gather_gbn

__all__ = ['compute_hyper_b']


def compute_hyper_b(c0, c1, inds):
    """Full ``hyper`` recompute: ``inds[i] & inds[c0[i]] & inds[c1[i]]``.

    ``c0/c1: int32 [N, B]``, ``inds: int32 [N, W, B]`` (bit patterns).
    The child rows are read with the row gather K1 (leaves carry NULL
    children, which gather zero rows, so their hyper rows are 0).
    """
    inds_wbn = inds.permute(1, 2, 0).contiguous()            # [W, B, N]
    inds_c0 = gather_gbn(inds_wbn, c0.T.contiguous())
    inds_c1 = gather_gbn(inds_wbn, c1.T.contiguous())
    return (inds_wbn & inds_c0 & inds_c1).permute(2, 0, 1).contiguous()
