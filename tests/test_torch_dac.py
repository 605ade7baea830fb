"""PyTorch port, DAC: ``MimiEncoderEngine`` on a ``DacConfig``
(device="cpu") against transformers' ``DacModel.encode`` on each utterance
zero-padded to whole frames, codes bit-equal, on a tiny two-block model;
the same batch against the benchmark's plain reference; ragged masked
batches against each row alone; the checkpoint converter under both
weight-norm namings and a plain weight; the configuration's defaults; the
modes the engine refuses; loading a snapshot by its ``model_type``; the
Snake counter and the ``tokenize_audio::dac.*`` ranges."""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tokenize_audio_tpu_torch import cli  # noqa: E402
from tokenize_audio_tpu_torch.codec import MimiCodec  # noqa: E402
from tokenize_audio_tpu_torch.config import EngineConfig  # noqa: E402
from tokenize_audio_tpu_torch.dac import model as dac_model  # noqa: E402
from tokenize_audio_tpu_torch.dac.config import DacConfig  # noqa: E402
from tokenize_audio_tpu_torch.dac.weights import convert_hf_state_dict  # noqa: E402
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine  # noqa: E402
from tokenize_audio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# two blocks (8 samples a frame; the units look 39 columns ahead at the
# first rate, 39 frames' worth at the second), 4 channels, 3 books of 32 x 4
TINY = dict(encoder_hidden_size=4, downsampling_ratios=[2, 4], n_codebooks=3, codebook_size=32,
            codebook_dim=4)
SPF = 8
BOOKS = 3
RATE = 44_100
# 1 sample, a frame, under the look-ahead, L % SPF != 0, one int16 row, and
# rows over a bucket of the lattice
LENGTHS = [1, 7, 8, 9, 31, 40, 79, 80, 333, 1000, 2047, 4100]


@pytest.fixture(scope="module")
def model():
    """A tiny ``DacModel`` with its convs weight-normed (the
    parametrization names of current torch), Snake alphas in [0.5, 1.5],
    N(0, 1) codebooks and small biases, so that every book uses many
    codes."""
    torch.manual_seed(0)
    hf = transformers.DacModel(transformers.DacConfig(**TINY)).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.5, 1.5)
            elif "codebook" in name:
                p.normal_()
            elif name.endswith("weight"):
                p.normal_().mul_(p[0].numel() ** -0.5)
            elif name.endswith("bias"):
                p.normal_().mul_(0.05)
    hf.apply_weight_norm()
    return hf, DacConfig(**TINY)


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(0)
    out = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in LENGTHS]
    out[8] = (out[8] * 32767).astype(np.int16)
    return out


def as_float(audio):
    return audio.astype(np.float32) / (32768.0 if audio.dtype == np.int16 else 1.0)


def hf_codes(hf, audio):
    """transformers' codes of ``audio`` zero-padded to whole frames, as
    DAC's preprocess pads it."""
    x = np.zeros(-(-len(audio) // SPF) * SPF, np.float32)
    x[: len(audio)] = as_float(audio)
    with torch.no_grad():
        return hf.encode(torch.from_numpy(x)[None, None]).audio_codes[0].numpy()


def engine(model, **kw):
    hf, cfg = model
    kw = dict(dict(batch_size=4, min_bucket_seconds=0.02, max_chunk_seconds=0.5, sample_rate=RATE),
              **kw)
    return MimiEncoderEngine(convert_hf_state_dict(hf.state_dict(), cfg), cfg, EngineConfig(**kw),
                             num_codebooks=BOOKS, device="cpu")


@pytest.mark.parametrize("fmt,dtype", [("padded", "int32"), ("padded", "uint16")])
def test_engine_equals_transformers_per_utterance(model, audios, fmt, dtype):
    """Masked ragged batches: each row's codes are transformers' on that row
    zero-padded to whole frames, in the configured dtype."""
    got = engine(model, code_transfer_format=fmt, code_transfer_dtype=dtype).encode_batch(audios, sr=RATE)
    for a, g in zip(audios, got):
        want = hf_codes(model[0], a)
        assert g.shape == want.shape == (BOOKS, -(-len(a) // SPF))
        assert g.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(g, want)


def test_a_ragged_batch_gives_each_row_its_codes_alone(model, audios):
    """One padded batch of every length (rows far shorter than the units'
    look-ahead among them) against each row encoded alone at its own
    whole-frame length, through the model's encode."""
    from tokenize_audio_tpu_torch.dac.weights import prepare

    hf, cfg = model
    params = prepare(convert_hf_state_dict(hf.state_dict(), cfg), cfg, BOOKS, "cpu")
    t = 4104  # whole frames past the longest row
    batch = np.zeros((len(audios), t), np.float32)
    for i, a in enumerate(audios):
        batch[i, : len(a)] = as_float(a)
    valid = torch.tensor([len(a) for a in audios], dtype=torch.int32)
    codes, frames = dac_model.encode(params, cfg, torch.from_numpy(batch), valid, BOOKS)
    assert frames.tolist() == [-(-len(a) // SPF) for a in audios]
    for i, a in enumerate(audios):
        alone, _ = dac_model.encode(params, cfg, torch.from_numpy(as_float(a))[None], None, BOOKS)
        assert alone.shape[-1] == frames[i]
        assert torch.equal(codes[i, :, : frames[i]], alone[0])


def test_engine_equals_the_plain_reference(model, audios):
    """The same batch against the benchmark's plain reference (its own
    weight-norm fold, one row at a time): every code the reference's best
    codeword, to rounding."""
    if str(ROOT / "port_bench") not in sys.path:
        sys.path.insert(0, str(ROOT / "port_bench"))
    from reference import dac_ref as ref
    hf, cfg = model
    sd = hf.state_dict()
    cfg_d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()}
    gaps = []
    for a, c in zip(audios, engine(model).encode_batch(audios, sr=RATE)):
        emb = ref.embeddings(sd, cfg_d, torch.from_numpy(as_float(a)))
        assert emb.shape == (cfg.hidden_size, c.shape[-1])
        gaps.append(float(ref.code_gaps(sd, cfg_d, emb, torch.from_numpy(c.astype(np.int64))).max()))
    assert max(gaps) < 1e-5


def test_converter_under_both_weight_norm_namings(model, audios):
    """transformers' parametrization names, the legacy ``weight_g`` /
    ``weight_v`` and a plain folded ``weight`` give one tree, and so the
    same codes."""
    hf, cfg = model
    sd = hf.state_dict()
    assert any(k.endswith("parametrizations.weight.original0") for k in sd)
    legacy = {k.replace("parametrizations.weight.original0", "weight_g")
              .replace("parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}
    plain = {k: v for k, v in sd.items() if "parametrizations" not in k}
    for name, mod in hf.named_modules():
        if isinstance(mod, torch.nn.Conv1d):
            plain[f"{name}.weight"] = mod.weight.detach()
    trees = [convert_hf_state_dict(d, cfg) for d in (sd, legacy, plain)]

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    for other in trees[1:]:
        for a, b in zip(leaves(trees[0]), leaves(other), strict=True):
            assert torch.equal(a, b)
    eng = MimiEncoderEngine(trees[1], cfg, EngineConfig(batch_size=4, min_bucket_seconds=0.02,
                                                        max_chunk_seconds=0.5, sample_rate=RATE),
                            num_codebooks=BOOKS, device="cpu")
    for a, g in zip(audios[9:], eng.encode_batch(audios[9:], sr=RATE)):
        np.testing.assert_array_equal(g, hf_codes(hf, a))


def test_defaults_are_transformers_key_for_key():
    hf = transformers.DacConfig()
    ours = DacConfig()
    modes = {"compute_dtype", "matmul_precision"}
    for f in dataclasses.fields(DacConfig):
        if f.name not in modes | {"sampling_rate"}:
            want = getattr(hf, f.name)
            want = tuple(want) if isinstance(want, list) else want
            assert getattr(ours, f.name) == want, f.name
    # the 44.1 kHz checkpoint's rate, where transformers' default is 16 kHz
    assert (hf.sampling_rate, ours.sampling_rate) == (16_000, 44_100)
    assert (ours.samples_per_frame, ours.hidden_size, ours.upsampling_ratios) == (512, 1024, (8, 8, 4, 2))
    with pytest.raises(ValueError, match="hop_length"):
        DacConfig(hop_length=320)


@pytest.mark.parametrize("what", ["unmasked", "bf16", "tf32", "stream", "mesh", "rate"])
def test_refusals_at_construction(model, what):
    hf, cfg = model
    params = convert_hf_state_dict(hf.state_dict(), cfg)
    kw, ecfg = {}, EngineConfig(sample_rate=RATE)
    if what == "unmasked":
        kw["masked"] = False
    elif what == "bf16":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    elif what == "tf32":
        cfg = dataclasses.replace(cfg, matmul_precision="high")
    elif what == "stream":
        ecfg = EngineConfig(sample_rate=RATE, long_audio_policy="stream")
    elif what == "mesh":
        kw["mesh"] = make_mesh(device="cpu")
    else:
        ecfg = EngineConfig()
    with pytest.raises(ValueError, match="DAC"):
        MimiEncoderEngine(params, cfg, ecfg, num_codebooks=BOOKS, device="cpu", **kw)


@pytest.fixture(scope="module")
def snapshot(model, tmp_path_factory):
    from safetensors.torch import save_file

    hf, _ = model
    path = tmp_path_factory.mktemp("dac_snapshot")
    hf.save_pretrained(str(path))
    if not (path / "model.safetensors").exists():
        save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
                  str(path / "model.safetensors"))
    assert json.loads((path / "config.json").read_text())["model_type"] == "dac"
    return path


def test_codec_loads_a_snapshot_by_model_type(model, audios, snapshot):
    from tokenize_audio_tpu_torch.codec import read_hf_snapshot

    params, cfg = read_hf_snapshot(str(snapshot))
    assert isinstance(cfg, DacConfig) and cfg.encoder_hidden_size == 4 and cfg.hop_length == SPF
    codec = MimiCodec(params, cfg, num_codebooks=BOOKS, device="cpu")
    # the engine runs at the snapshot's own rate (transformers' default 16 kHz)
    assert codec.engine.engine_cfg.sample_rate == cfg.sampling_rate == 16_000
    a = audios[10]
    np.testing.assert_array_equal(codec.encode(a, sr=cfg.sampling_rate), hf_codes(model[0], a))
    s = codec.audio_to_str(a, sr=cfg.sampling_rate)
    assert len(s) == BOOKS * -(-len(a) // SPF)
    with pytest.raises(NotImplementedError, match="DAC"):
        codec.str_to_audio(s)


def test_cli_engine_from_a_snapshot(model, audios, snapshot):
    ap = argparse.ArgumentParser()
    cli.add_engine_args(ap)
    eng = cli.engine_from_args(ap.parse_args(["--device", "cpu", "--params", str(snapshot)]),
                               num_codebooks=BOOKS)
    assert isinstance(eng.cfg, DacConfig) and eng.engine_cfg.sample_rate == 16_000
    a = audios[11]
    np.testing.assert_array_equal(eng.encode_chunk(a, sr=16_000), hf_codes(model[0], a))
    with pytest.raises(ValueError, match="TF32"):
        cli.engine_from_args(ap.parse_args(["--device", "cpu", "--params", str(snapshot),
                                            "--precision", "high"]))


def test_snake_count_and_ranges(model, audios):
    """Fifteen Snakes a batch at two blocks (seven a block and the last
    one), each in a ``tokenize_audio::dac.snake`` range, with the encoder,
    the quantizer and the pack in theirs."""
    eng = engine(model)
    before = dac_model.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.encode_batch(audios[:6], sr=RATE)
    batches = eng.stats.batches
    assert batches >= 1 and dac_model.launches - before == 15 * batches
    names = [e.name for e in prof.events()]
    assert names.count("tokenize_audio::dac.snake") == 15 * batches
    for stage in ("encoder", "rvq", "pack"):
        assert names.count(f"tokenize_audio::dac.{stage}") == batches
    assert not any(n.startswith(("tokenize_audio::mimi.", "tokenize_audio::encodec.")) for n in names)
    assert eng.stats.lstm_steps == 0


def test_unmasked_encode_is_refused(model):
    from tokenize_audio_tpu_torch.dac.weights import prepare

    hf, cfg = model
    params = prepare(convert_hf_state_dict(hf.state_dict(), cfg), cfg, BOOKS, "cpu")
    with pytest.raises(ValueError, match="masked"):
        dac_model.encode(params, cfg, torch.zeros((1, 16)), None, BOOKS, masked=False)
