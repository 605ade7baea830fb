"""The contract of a model's batch encode (``mimi.model.encode``,
``encodec.model.encode``), which the engine relies on, written once: what
runs before the model's layers (``encode_prologue``) and after them
(``encode_epilogue``, the codes' layout for their copy to the host, which
the engine unpacks in ``engine.encoder._trim``)."""

from __future__ import annotations

import torch

from tokenize_audio_tpu_torch.core import audio as core_audio
from tokenize_audio_tpu_torch.ranges import span


def encode_prologue(model, audio, valid, masked, resample, samples_per_frame):
    """The (B, T) batch and per-row sample counts as the model's layers take
    them: returns ``(audio, valid, frames)``.

    int16 PCM becomes float32 on the device (x / 32768, exact, so raw PCM
    ships at half the bytes with the same codes); another integer dtype is
    refused. ``resample`` = (up, down) runs the fused polyphase resample
    (rows at the source rate) in the ``<model>.resample`` range and takes
    ``valid`` to ceil(valid * up / down); it needs masked rows with
    ``valid``, since only the masked invariant keeps each row's codes those
    of resample-then-encode. Unmasked, the layers get ``valid=None`` and
    ``frames`` holds each row's frame count, ceil(valid /
    samples_per_frame); masked, ``frames`` is None."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    elif not audio.dtype.is_floating_point:
        raise TypeError(
            f"integer audio must be int16 PCM (got {audio.dtype}); "
            "normalize other PCM widths on host via pcm_to_float"
        )
    if resample is not None:
        if not masked or valid is None:
            raise ValueError("fused resample requires masked=True with valid lengths")
        up, down = resample
        with span(f"{model}.resample"):
            # looked up at each call, so a wrapper put on the name sees it
            audio = core_audio._resample_batch(audio.to(torch.float32), up, down)
        valid = (valid * up + down - 1) // down
    if masked or valid is None:
        return audio, valid, None
    return audio, None, (valid + samples_per_frame - 1) // samples_per_frame


def encode_epilogue(model, codes, valid, frames, num_quantizers, code_dtype, transfer):
    """``(codes in the transfer layout, per-row frame counts)`` from the
    layers' (B, K, T) codes and frame ``valid``, or, unmasked, the
    prologue's ``frames``; the layout runs in the ``<model>.pack`` range."""
    with span(f"{model}.pack"):
        return transfer_layout(codes, num_quantizers, code_dtype, transfer), (
            frames if valid is None else valid
        )


def transfer_layout(codes, num_quantizers, code_dtype, transfer):
    """The (B, K, T) codes in a model encode's ``transfer`` wire format:
    "padded" (``code_dtype``) or "packed" (adjacent books' codes as the two
    halves of an int32)."""
    if transfer == "padded":
        return codes.to(getattr(torch, code_dtype))
    if transfer != "packed":
        raise ValueError(f"unknown transfer mode {transfer!r}: 'padded' or 'packed'")
    if num_quantizers % 2 != 0:
        raise ValueError(f"packed transfer needs even num_quantizers, got {num_quantizers}")
    # pack adjacent code pairs little-endian into int32 words: the host
    # recovers the exact (.., K) uint16 stream with a zero-copy view('<u2')
    ct = codes.transpose(1, 2).to(torch.int32)  # (B, T, K)
    return ct[..., 0::2] | (ct[..., 1::2] << 16)  # (B, T, K//2)
