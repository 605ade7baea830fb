"""PyTorch port, code <-> unicode converter: ``core.codes`` of the port
against the JAX package's module over seeded random, truncated and
corrupted code streams, plus the edge cases of tests/test_codes.py."""

import numpy as np
import pytest
import torch

from tokenize_audio_tpu.core import codes as jax_codes
from tokenize_audio_tpu_torch.config import (
    CODEBOOK_SIZE,
    NUM_CODEBOOKS,
    UNICODE_OFFSET,
    UNICODE_OFFSET_LARGE,
)
from tokenize_audio_tpu_torch.core.codes import (
    chars_to_codes,
    codes_to_chars,
    resolve_codebook,
    validate_unicode_offset,
)

K, S = NUM_CODEBOOKS, CODEBOOK_SIZE


def random_codes(rng, k=K, t=40):
    return rng.integers(0, S, size=(k, t), dtype=np.int64)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("offset", [UNICODE_OFFSET, UNICODE_OFFSET_LARGE])
def test_equal_to_jax_on_clean_truncated_and_corrupted_streams(seed, offset):
    rng = np.random.default_rng(seed)
    k = [1, 2, 8][seed % 3]
    codes = rng.integers(0, S, size=(k, int(rng.integers(1, 60))), dtype=np.int64)
    s = codes_to_chars(codes, S, unicode_offset=offset)
    assert s == jax_codes.codes_to_chars(codes, S, unicode_offset=offset)
    # chop the head and tail, delete a few characters, insert a lone surrogate
    lo, hi = int(rng.integers(0, 6)), len(s) - int(rng.integers(0, 6))
    dirty = "".join(c for c in s[lo:hi] if rng.random() > 0.03)
    dirty = dirty[: len(dirty) // 2] + "\ud800" + dirty[len(dirty) // 2 :]
    for text in (s, dirty):
        got = chars_to_codes(text, k, S, unicode_offset=offset,
                             return_hanging_codes_chars=True)
        want = jax_codes.chars_to_codes(text, k, S, unicode_offset=offset,
                                        return_hanging_codes_chars=True)
        assert got == want
    np.testing.assert_array_equal(chars_to_codes(s, k, S, unicode_offset=offset,
                                                 return_tensors="np"), codes)


def test_roundtrip_np_list_and_pt(rng):
    codes = random_codes(rng, t=5)
    s = codes_to_chars(torch.from_numpy(codes), S, unicode_offset=UNICODE_OFFSET_LARGE)
    assert s == codes_to_chars(codes.tolist(), S, unicode_offset=UNICODE_OFFSET_LARGE)
    assert chars_to_codes(s, K, S, unicode_offset=UNICODE_OFFSET_LARGE) == codes.tolist()
    back_np = chars_to_codes(s, K, S, return_tensors="np", unicode_offset=UNICODE_OFFSET_LARGE)
    assert back_np.dtype == np.int64
    np.testing.assert_array_equal(back_np, codes)
    back_pt = chars_to_codes(s, K, S, return_tensors="pt", unicode_offset=UNICODE_OFFSET_LARGE)
    assert isinstance(back_pt, torch.Tensor)
    np.testing.assert_array_equal(back_pt.numpy(), codes)
    with pytest.raises(ValueError, match="return_tensors"):
        chars_to_codes(s, K, S, return_tensors="tf", unicode_offset=UNICODE_OFFSET_LARGE)


def test_frame_major_interleave_and_default_offset():
    codes = np.array([[0, 2], [1, 3]])
    s = codes_to_chars(codes, 4, unicode_offset=0xE000)
    assert [ord(c) for c in s] == [0xE000 + 0, 0xE004 + 1, 0xE000 + 2, 0xE004 + 3]
    assert ord(codes_to_chars(np.array([[0], [0]]), 4)[0]) == 0x4E00


def test_surrogate_offsets_rejected():
    assert validate_unicode_offset(0x4E00, 8, 2048) == 0x4E00
    for bad in (0xDFFF, 0xD800, 0xD000):
        with pytest.raises(ValueError, match="surrogate"):
            validate_unicode_offset(bad, 8, 2048)
    with pytest.raises(ValueError, match="surrogate"):
        codes_to_chars(np.zeros((32, 2), dtype=np.int64), 2048, unicode_offset=0x4E00)
    assert validate_unicode_offset(0xE000, 32, 2048) == 0xE000
    assert validate_unicode_offset(0xD800 - 8 * 2048, 8, 2048)  # ends at 0xD800


def test_resolve_codebook_clamping():
    off = 0xE000
    assert resolve_codebook(off - 1, 4, 16, off) == -1
    assert resolve_codebook(off, 4, 16, off) == 0
    assert resolve_codebook(off + 16 * 9, 4, 16, off) == 3
    arr = np.array([off - 1, off + 16, off + 16 * 9])
    np.testing.assert_array_equal(resolve_codebook(arr, 4, 16, off), [-1, 1, 3])


def test_drop_hanging_codes(rng):
    codes = random_codes(rng, t=6)
    s = codes_to_chars(codes, S, unicode_offset=UNICODE_OFFSET_LARGE)
    out, begin_h, end_h = chars_to_codes(
        s[3:-2], K, S, return_tensors="np", return_hanging_codes_chars=True,
        unicode_offset=UNICODE_OFFSET_LARGE,
    )
    np.testing.assert_array_equal(out, codes[:, 1:-1])
    assert begin_h == s[3:K]
    assert end_h == s[-K:-2]


def test_drop_inconsistent_codes():
    off, k, size = 0xE000, 4, 16
    clean = np.array([[1, 2], [3, 4], [5, 6], [7, 8]])
    s = codes_to_chars(clean, size, unicode_offset=off)
    dirty = s[:2] + s[2] + s[2:]  # a duplicate codebook-2 character mid-frame
    np.testing.assert_array_equal(
        chars_to_codes(dirty, k, size, return_tensors="np", unicode_offset=off), clean)


def test_lone_surrogate_dropped_and_non_divisible_raises(rng):
    codes = random_codes(rng, t=4)
    s = codes_to_chars(codes, S, unicode_offset=UNICODE_OFFSET_LARGE)
    out = chars_to_codes(s[:8] + "\ud800" + s[8:], K, S, return_tensors="np",
                         unicode_offset=UNICODE_OFFSET_LARGE)
    np.testing.assert_array_equal(out, codes)
    with pytest.raises(ValueError, match="divisible"):
        chars_to_codes(s[1:], K, S, drop_inconsistent_codes=False, drop_hanging_codes=False,
                       unicode_offset=UNICODE_OFFSET_LARGE)
