"""The codes' layout for their copy to the host, shared by the models'
encodes (``mimi.model.encode``, ``encodec.model.encode``): the engine
unpacks each layout in ``engine.encoder._collect``."""

from __future__ import annotations

import torch


def transfer_layout(codes, valid, num_quantizers, code_dtype, transfer):
    """The (B, K, T) codes in a model encode's ``transfer`` wire format:
    "padded" (``code_dtype``), "packed" (adjacent books' codes as the two
    halves of an int32), or "compact" (packed, the valid frames only)."""
    if transfer == "padded":
        return codes.to(getattr(torch, code_dtype))
    if num_quantizers % 2 != 0:
        raise ValueError(f"packed transfer needs even num_quantizers, got {num_quantizers}")
    # pack adjacent code pairs little-endian into int32 words: the host
    # recovers the exact (.., K) uint16 stream with a zero-copy view('<u2')
    ct = codes.transpose(1, 2).to(torch.int32)  # (B, T, K)
    packed = ct[..., 0::2] | (ct[..., 1::2] << 16)  # (B, T, K//2)
    if transfer == "packed":
        return packed
    if transfer != "compact":
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if valid is None:
        raise ValueError("compact transfer requires valid lengths")
    b, t, kp = packed.shape
    pos = torch.arange(t, device=packed.device, dtype=torch.int32)[None, :]
    fmask = (pos < valid[:, None]).reshape(-1)
    # stable compaction: row-major frame order is preserved, so the host
    # splits the prefix by cumulative per-row frame counts; invalid frames
    # all land on one spill row that is cut off
    tgt = torch.where(fmask, torch.cumsum(fmask.long(), 0) - 1, b * t)
    out = torch.zeros((b * t + 1, kp), dtype=torch.int32, device=packed.device)
    out.index_copy_(0, tgt, packed.reshape(b * t, kp))
    return out[: b * t]
