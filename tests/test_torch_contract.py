"""PyTorch port, the encode contract both models share (``core/contract.py``):
the prologue's int16 normalization, fused resample, ``valid`` update and
unmasked frame counts, and the epilogue's wire layout, against values
worked out by hand on the CPU."""

import numpy as np
import pytest
import torch

from tokenize_audio_tpu_torch.core import audio as core_audio
from tokenize_audio_tpu_torch.core.contract import (
    encode_epilogue,
    encode_prologue,
    transfer_layout,
)

SPF = 1920
LENGTHS = [7, 1920, 4001]
PCM = np.array([[-32768, -1, 0, 1, 16384, 32767] * 700] * 3, dtype=np.int16)  # (3, 4200)


def batch(dtype):
    x = torch.from_numpy(PCM)
    return x if dtype == "int16" else x.to(torch.float32) / 32768.0


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("mode,resample,want_valid,want_frames", [
    # masked: the layers get each row's samples, and no frame counts
    ("masked", None, LENGTHS, None),
    # fused 16 -> 24 kHz: valid becomes ceil(valid * 3 / 2)
    ("masked", (3, 2), [11, 2880, 6002], None),
    # unmasked: the layers get no valid; the frames are ceil(valid / 1920)
    ("unmasked", None, None, [1, 1, 3]),
])
def test_prologue(dtype, mode, resample, want_valid, want_frames):
    valid = torch.tensor(LENGTHS, dtype=torch.int32)
    audio, got_valid, frames = encode_prologue(
        "mimi", batch(dtype), valid, mode == "masked", resample, SPF)
    assert audio.dtype == torch.float32
    pcm = torch.from_numpy(PCM).to(torch.float64) / 32768.0  # exact in float32
    if resample is None:
        assert audio.shape == PCM.shape
        assert torch.equal(audio.to(torch.float64), pcm)
    else:
        assert audio.shape == (3, PCM.shape[1] * 3 // 2)
        assert torch.equal(audio, core_audio._resample_batch(pcm.to(torch.float32), *resample))
    assert (None if got_valid is None else got_valid.tolist()) == want_valid
    assert (None if frames is None else frames.tolist()) == want_frames


@pytest.mark.parametrize("what", ["unmasked resample", "int32 audio"])
def test_prologue_refusals(what):
    valid = torch.tensor(LENGTHS, dtype=torch.int32)
    if what == "unmasked resample":
        with pytest.raises(ValueError, match="masked=True"):
            encode_prologue("mimi", batch("int16"), valid, False, (3, 2), SPF)
    else:
        with pytest.raises(TypeError, match="int16 PCM"):
            encode_prologue("mimi", torch.from_numpy(PCM.astype(np.int32)), valid, True, None, SPF)


@pytest.mark.parametrize("transfer", ["padded", "packed"])
def test_epilogue_layout_and_frames(transfer):
    """Padded keeps (B, K, T) in the code dtype; packed puts books 2j and
    2j + 1 of a frame in the low and high halves of one int32, which the
    host reads back with a little-endian uint16 view. The frame counts are
    the layers' ``valid``, or the prologue's where the layers had none."""
    codes = torch.tensor([[[0, 1, 2047], [5, 6, 7], [2047, 0, 3], [1, 1, 1]]])  # (1, 4, 3)
    frames = torch.tensor([2])
    got, n = encode_epilogue("encodec", codes, None, frames, 4, "uint16", transfer)
    assert n is frames
    if transfer == "padded":
        assert got.dtype == torch.uint16 and torch.equal(got.to(torch.int64), codes)
    else:
        assert got.dtype == torch.int32 and got.shape == (1, 3, 2)
        assert got[0, 0].tolist() == [0 | 5 << 16, 2047 | 1 << 16]
        u16 = np.ascontiguousarray(got.numpy()).view("<u2").reshape(1, 3, 4)  # (B, T, K)
        np.testing.assert_array_equal(u16.transpose(0, 2, 1), codes.numpy())
    valid = torch.tensor([3])
    assert encode_epilogue("encodec", codes, valid, None, 4, "int32", transfer)[1] is valid


@pytest.mark.parametrize("transfer,k,match", [("compact", 4, "'compact'"),
                                              ("packed", 3, "even")])
def test_transfer_layout_refusals(transfer, k, match):
    with pytest.raises(ValueError, match=match):
        transfer_layout(torch.zeros((1, k, 2), dtype=torch.int64), k, "int32", transfer)
