"""PyTorch port, I/O: WAV, FLAC and mp3 decode bit-equal to the JAX package's
``io`` on the same bytes (FLAC fixtures of every subframe kind and stereo
mode), the decode registry (magic sniff, raw int16, mixdown), the JSON code
serializer, and ``prefetch_map``'s order and errors."""

import struct
import threading

import numpy as np
import pytest

from tests.flac_encoder import encode_flac
from tokenize_audio_tpu.io import decode as jax_decode
from tokenize_audio_tpu.io.flac import read_flac as jax_read_flac
from tokenize_audio_tpu.io.jsonfast import int_matrix_to_json as jax_int_matrix_to_json
from tokenize_audio_tpu.io.wav import read_wav as jax_read_wav
from tokenize_audio_tpu_torch.io import decode, flac, mp3
from tokenize_audio_tpu_torch.io.jsonfast import int_matrix_to_json
from tokenize_audio_tpu_torch.io.prefetch import prefetch_map
from tokenize_audio_tpu_torch.io.wav import read_wav, write_wav


def assert_same(got, want):
    """(audio, sr) pairs equal bit for bit, dtype and shape included."""
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])


def wav_bytes(payload: bytes, fmt: int, channels: int, bits: int, sr: int = 24_000,
              extensible: bool = False) -> bytes:
    block = channels * bits // 8
    body = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, channels, sr, sr * block,
                       block, bits)
    if extensible:  # cbSize, valid bits, channel mask, SubFormat GUID
        body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) + b"\x00" * 14
    chunks = b"fmt " + struct.pack("<I", len(body)) + body
    chunks += b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # odd chunk, word-aligned
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def wav_case(rng, kind, channels):
    n = 1001 * channels
    if kind == "pcm8":
        return wav_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), 1, channels, 8)
    if kind == "pcm16":
        return wav_bytes(rng.integers(-32768, 32768, n).astype("<i2").tobytes(), 1, channels, 16)
    if kind == "pcm16_ext":
        return wav_bytes(rng.integers(-32768, 32768, n).astype("<i2").tobytes(), 1, channels, 16,
                         extensible=True)
    if kind == "pcm24":
        return wav_bytes(rng.integers(0, 256, n * 3, dtype=np.uint8).tobytes(), 1, channels, 24)
    if kind == "pcm32":
        return wav_bytes(rng.integers(-2**31, 2**31, n).astype("<i4").tobytes(), 1, channels, 32)
    if kind == "float32":
        return wav_bytes(rng.standard_normal(n).astype("<f4").tobytes(), 3, channels, 32)
    return wav_bytes(rng.standard_normal(n).astype("<f8").tobytes(), 3, channels, 64)


@pytest.mark.parametrize("raw_int16", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize(
    "kind", ["pcm8", "pcm16", "pcm16_ext", "pcm24", "pcm32", "float32", "float64"])
def test_wav_equals_jax(kind, channels, raw_int16):
    data = wav_case(np.random.default_rng(len(kind) * 10 + channels), kind, channels)
    want = jax_read_wav(data, raw_int16=raw_int16)
    assert_same(read_wav(data, raw_int16=raw_int16), want)
    assert_same(decode.decode_audio(data, raw_int16=raw_int16),
                jax_decode.decode_audio(data, raw_int16=raw_int16))


@pytest.mark.parametrize("data", [b"", b"RIFF\x00\x00\x00\x00WAVE", b"RIFFxxxxWAVEfmt \x02\x00\x00\x00ab",
                                  wav_bytes(b"\x00" * 8, 2, 1, 16)])
def test_wav_malformed_raises_like_jax(data):
    for fn in (read_wav, jax_read_wav):
        with pytest.raises(ValueError):
            fn(data)


def test_write_wav_bytes_equal_jax(tmp_path):
    from tokenize_audio_tpu.io.wav import write_wav as jax_write_wav

    audio = np.random.default_rng(1).uniform(-1.2, 1.2, (2000, 2)).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), audio, 16_000)
    jax_write_wav(str(tmp_path / "b.wav"), audio, 16_000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def pcm(rng, n, channels=1, amp=20000):
    x = (rng.standard_normal((n, channels)) * amp / 4).clip(-amp, amp).astype(np.int64)
    return x if channels > 1 else x[:, 0]


FLAC_CASES = [
    dict(subframe_kinds=[k]) for k in
    ("verbatim", "constant", "fixed0", "fixed1", "fixed2", "fixed3", "fixed4", "lpc")
] + [
    dict(subframe_kinds=["verbatim", "fixed2", "lpc"]),
    dict(subframe_kinds=["fixed2"], escape=True),
    dict(subframe_kinds=["verbatim"], wasted=3),
] + [dict(channels=2, stereo_mode=m)
     for m in ("independent", "left_side", "right_side", "mid_side")]


@pytest.mark.parametrize("raw_int16", [False, True])
@pytest.mark.parametrize("case", FLAC_CASES, ids=lambda c: "-".join(
    str(v if not isinstance(v, list) else "+".join(v)) for v in c.values()))
def test_flac_equals_jax(case, raw_int16):
    case = dict(case)
    channels = case.pop("channels", 1)
    rng = np.random.default_rng(7)
    x = pcm(rng, 4096 + 333, channels)  # a short last block
    if case.get("subframe_kinds") == ["constant"]:
        x[:] = -1234
    if case.get("wasted"):
        x = (x >> 3) << 3
    data = encode_flac(x, blocksize=1024, **case)
    got = flac.read_flac(data, raw_int16=raw_int16)
    assert_same(got, jax_read_flac(data, raw_int16=raw_int16))
    scale = 1 if raw_int16 else 32768
    np.testing.assert_array_equal(np.round(got[0].astype(np.float64) * scale), x)
    assert_same(decode.decode_audio(data, raw_int16=raw_int16),
                jax_decode.decode_audio(data, raw_int16=raw_int16))


def test_flac_malformed_inputs_never_crash():
    """Truncations and bit flips raise ValueError or decode fewer samples,
    as the JAX package's decoder does on the same bytes."""
    rng = np.random.default_rng(9)
    data = bytearray(encode_flac(pcm(rng, 3000), blocksize=512,
                                 subframe_kinds=["fixed2", "lpc"]))
    cases = [bytes(data[:cut]) for cut in range(40, len(data), len(data) // 17)]
    for seed in range(40):
        r = np.random.default_rng(seed)
        mut = bytearray(data)
        mut[int(r.integers(60, len(data)))] ^= int(r.integers(1, 256))
        cases.append(bytes(mut))
    cases.append(b"RIFFxxxxWAVE" + b"\x00" * 50)
    for blob in cases:
        outcome = []
        for fn in (flac.read_flac, jax_read_flac):
            try:
                audio, sr = fn(blob)
                outcome.append((audio.tobytes(), sr))
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]


def test_flac_library_builds_into_the_port_build_dir():
    import os

    flac._load()
    assert os.path.dirname(flac._LIB) == os.path.join(
        os.path.dirname(os.path.dirname(flac.__file__)), "_build")
    assert os.path.isfile(flac._LIB)


def test_flac_build_without_gxx_raises(tmp_path, monkeypatch):
    """A missing g++ is an error at first use, not a silently unregistered
    format."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(flac, "_LIB", str(tmp_path / "libflac_decoder.so"))
    monkeypatch.setattr(flac, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(flac, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        flac.read_flac(encode_flac(np.zeros(10, dtype=np.int64)))
    assert "flac" in decode._DECODERS


@pytest.mark.parametrize("fmt,sniffed", [("wav", "wav"), ("flac", "flac"), ("id3", "mp3"),
                                         ("mpeg", "mp3"), ("junk", None)])
def test_magic_sniff_equals_jax(fmt, sniffed):
    blob = {"wav": wav_case(np.random.default_rng(0), "pcm16", 1),
            "flac": encode_flac(np.zeros(100, dtype=np.int64)), "id3": b"ID3\x04" + b"\x00" * 20,
            "mpeg": b"\xff\xfb\x90\x00" + b"\x00" * 20, "junk": b"\x00" * 24}[fmt]
    assert decode._sniff(blob) == jax_decode._sniff(blob) == sniffed


def test_decode_from_path_mixdown_and_raw_int16(tmp_path):
    """Paths pick the decoder by extension; a stereo raw-int16 request mixes
    down in normalized float32 (never an int16 mean)."""
    rng = np.random.default_rng(4)
    x = pcm(rng, 2000, channels=2)
    path = str(tmp_path / "a.flac")
    with open(path, "wb") as f:
        f.write(encode_flac(x, stereo_mode="mid_side"))
    got = decode.decode_audio(path, raw_int16=True)
    assert got[0].dtype == np.float32 and got[0].shape == (2000,)
    assert_same(got, jax_decode.decode_audio(path, raw_int16=True))
    np.testing.assert_allclose(got[0], (x[:, 0] + x[:, 1]) / 65536, atol=1e-6)
    wav = str(tmp_path / "b.wav")
    write_wav(wav, x / 32768.0, 24_000)
    assert_same(decode.decode_audio(wav, mono=False), jax_decode.decode_audio(wav, mono=False))
    mono16 = str(tmp_path / "c.wav")
    write_wav(mono16, x[:, 0] / 32767.0, 16_000)
    got = decode.decode_audio(mono16, raw_int16=True)
    assert got[0].dtype == np.int16 and got[1] == 16_000
    assert_same(got, jax_decode.decode_audio(mono16, raw_int16=True))


def test_decoder_registry(monkeypatch):
    monkeypatch.setattr(decode, "_DECODERS", dict(decode._DECODERS))
    decode.register_decoder("TONE", lambda data: (np.ones(3, dtype=np.float64), 8000))
    audio, sr = decode.decode_audio(b"xx", format="tone", raw_int16=True)
    assert sr == 8000 and audio.dtype == np.float32
    with pytest.raises(ValueError, match="no decoder for format 'ogg'"):
        decode.decode_audio(b"OggS", format="ogg")


def test_mp3_registers_and_decodes_like_jax():
    """mp3 registers exactly when the JAX package finds libmpg123, and
    decodes the same samples."""
    assert ("mp3" in decode._DECODERS) == ("mp3" in jax_decode._DECODERS)
    if "mp3" not in decode._DECODERS:
        pytest.skip("libmpg123 is not installed")
    from tests.mp3_encoder import encode_mp3
    from tokenize_audio_tpu.io.mp3 import read_mp3 as jax_read_mp3

    t = np.arange(24_000) / 24_000
    data = encode_mp3((0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), 24_000)
    assert_same(mp3.read_mp3(data), jax_read_mp3(data))
    assert_same(decode.decode_audio(data), jax_decode.decode_audio(data))
    with pytest.raises(ValueError):
        mp3.read_mp3(b"")


INT_MATRICES = [
    np.random.default_rng(0).integers(0, 65536, size=(8, 301), dtype=np.uint16),
    np.array([0, 9, 10, 99, 100, 65535], dtype=np.uint16),
    np.zeros((4, 0), dtype=np.uint16),
    np.zeros((0, 4), dtype=np.int32),
    np.zeros(0, dtype=np.uint16),
    np.array([[70000, -3]], dtype=np.int64),  # out of the table's range
    np.array([1.5, 2.5]),  # not integers
    np.zeros((2, 2, 2), dtype=np.uint16),  # not 1-D or 2-D
]


@pytest.mark.parametrize("i", range(len(INT_MATRICES)))
def test_int_matrix_to_json_equals_jax(i):
    import json

    a = INT_MATRICES[i]
    got = int_matrix_to_json(a)
    assert got == jax_int_matrix_to_json(a)
    assert json.loads(got) == a.tolist()


def test_prefetch_map_order_bound_and_errors():
    """Results come in input order with at most ``depth`` items in flight;
    an error in ``fn`` propagates at its item; workers=0 runs inline."""
    lock = threading.Lock()
    inflight, peak = [0], [0]

    def fn(i):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        try:
            return i * i
        finally:
            with lock:
                inflight[0] -= 1

    assert list(prefetch_map(fn, range(50), workers=3, depth=4)) == [i * i for i in range(50)]
    assert peak[0] <= 4
    assert list(prefetch_map(fn, range(5), workers=0)) == [0, 1, 4, 9, 16]

    def boom(i):
        if i == 3:
            raise KeyError("bad item")
        return i

    it = prefetch_map(boom, range(10), workers=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError):
        next(it)

    def stop(i):
        raise StopIteration  # a failure of fn, not the end of the items

    with pytest.raises(RuntimeError):
        list(prefetch_map(stop, range(3), workers=1))
