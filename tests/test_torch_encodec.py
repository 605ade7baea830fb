"""PyTorch port, EnCodec: ``MimiEncoderEngine`` on an ``EncodecConfig``
(device="cpu") against transformers' ``EncodecModel.encode``, one utterance
at a time, codes bit-equal, on a tiny two-stride model with the published
two LSTM layers; the same batch against the benchmark's plain reference;
the checkpoint converter under both weight-norm namings; the
configuration's defaults and bandwidths; the modes the engine refuses;
loading a snapshot by its ``model_type``; the LSTM's plain path on the CPU,
its kernel's packed weights and launch count; the ``lstm_steps`` counter
and the ``tokenize_audio::encodec.*`` ranges."""

import argparse
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tokenize_audio_tpu_torch import cli  # noqa: E402
from tokenize_audio_tpu_torch.codec import MimiCodec  # noqa: E402
from tokenize_audio_tpu_torch.config import EngineConfig  # noqa: E402
from tokenize_audio_tpu_torch.encodec.config import EncodecConfig  # noqa: E402
from tokenize_audio_tpu_torch.encodec import weights as encodec_weights  # noqa: E402
from tokenize_audio_tpu_torch.encodec.weights import convert_hf_state_dict  # noqa: E402
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine  # noqa: E402
from tokenize_audio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# two strides (8 samples a frame), narrow channels, the published two LSTM
# layers; bandwidths that give 1-12 books of 64 entries at 3000 frames a
# second
TINY = dict(num_filters=4, hidden_size=16, upsampling_ratios=[4, 2], codebook_size=64,
            target_bandwidths=[18.0, 36.0, 72.0, 144.0, 216.0])
SPF = 8
BOOKS = 8
BANDWIDTH = 144.0  # 8 books
# 1-3 frames, under the input conv's reflect pad (6), L % SPF != 0, one
# int16 row, and rows over a bucket of the 0.25 s lattice
LENGTHS = [1, 3, 5, 8, 9, 17, 23, 100, 333, 5001, 7777, 12_000, 24_000, 30_001]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's encodes on one torch thread: the LSTM steps through
    thousands of frames, each a parallel region of a few microseconds, and
    under the parallel test runner the cores are shared by several
    workers, where waiting on sibling threads at every step costs far more
    than the step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    hf = transformers.EncodecModel(transformers.EncodecConfig(**TINY)).eval()
    with torch.no_grad():
        for name, buf in hf.named_buffers():
            if name.endswith("codebook.embed"):
                buf.normal_()
    return hf, EncodecConfig(**TINY)


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(0)
    out = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in LENGTHS]
    out[8] = (out[8] * 32767).astype(np.int16)
    return out


def hf_codes(hf, audio, bandwidth=BANDWIDTH):
    x = audio.astype(np.float32) / (32768.0 if audio.dtype == np.int16 else 1.0)
    with torch.no_grad():
        return hf.encode(torch.from_numpy(x)[None, None], bandwidth=bandwidth).audio_codes[0, 0].numpy()


def engine(model, **kw):
    hf, cfg = model
    kw = dict(dict(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0), **kw)
    return MimiEncoderEngine(convert_hf_state_dict(hf.state_dict(), cfg), cfg, EngineConfig(**kw),
                             num_codebooks=BOOKS, device="cpu")


@pytest.mark.parametrize("fmt,dtype", [("padded", "int32"), ("packed", "int32"),
                                       ("padded", "uint16")],
                         ids=["padded", "packed", "padded-uint16"])
def test_engine_equals_transformers_per_utterance(model, audios, fmt, dtype):
    """Masked batches of mixed lengths, both transfer formats and the
    narrow code dtype: each row's codes are its standalone encode's,
    reflect padding at its own end, in the configured dtype."""
    eng = engine(model, code_transfer_format=fmt, code_transfer_dtype=dtype)
    got = eng.encode_batch(audios)
    for a, g in zip(audios, got):
        want = hf_codes(model[0], a)
        assert g.shape == want.shape == (BOOKS, -(-len(a) // SPF))
        assert g.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(g, want)


def test_engine_equals_the_plain_reference(model, audios):
    """The same batch against the benchmark's plain reference (its own
    weight-norm fold and an LSTM written out as cell equations): every
    code the reference's nearest codeword, to rounding."""
    spec = importlib.util.spec_from_file_location(
        "encodec_ref", ROOT / "port_bench" / "reference" / "encodec_ref.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    hf, cfg = model
    sd = hf.state_dict()
    cfg_d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()}
    gaps = []
    for a, c in zip(audios, engine(model).encode_batch(audios)):
        x = torch.from_numpy(a.astype(np.float32) / (32768.0 if a.dtype == np.int16 else 1.0))
        emb = ref.embeddings(sd, cfg_d, x)
        gaps.append(float(ref.code_gaps(sd, cfg_d, emb, torch.from_numpy(c)).max()))
    assert max(gaps) < 1e-5


def test_fused_and_host_resample_equal_resample_then_encode(model):
    """48 kHz takes the fused on-device resample (a frame is 16 source
    samples), 16 kHz the batched one; both equal encoding the resampled
    24 kHz audio."""
    from tokenize_audio_tpu_torch.core.audio import resample

    eng = engine(model)
    rng = np.random.default_rng(2)
    for sr in (48_000, 16_000):
        src = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (13, 999, 20_000)]
        got = eng.encode_batch(src, sr=sr)
        for a, g in zip(src, got):
            want = eng.encode_batch([resample(a, sr, 24_000, device="cpu").numpy()])[0]
            np.testing.assert_array_equal(g, want)


def test_converter_under_both_weight_norm_namings(model):
    """transformers' parametrization names, the published files' legacy
    ``weight_g``/``weight_v`` and a plain folded ``weight`` give one tree."""
    hf, cfg = model
    sd = hf.state_dict()
    assert any(k.endswith("parametrizations.weight.original0") for k in sd)
    legacy, plain = {}, {}
    for k, v in sd.items():
        legacy[k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v")] = v
    for name, mod in hf.named_modules():
        if isinstance(mod, torch.nn.Conv1d) and name.startswith("encoder."):
            plain[f"{name}.weight"] = mod.weight.detach()
            plain[f"{name}.bias"] = mod.bias.detach()
    plain.update({k: v for k, v in sd.items() if ".lstm." in k or k.startswith("quantizer.")})
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


def test_defaults_are_transformers_key_for_key():
    hf = transformers.EncodecConfig()
    ours = EncodecConfig()
    modes = {"compute_dtype", "matmul_precision"}
    for f in dataclasses.fields(EncodecConfig):
        if f.name not in modes:
            want = getattr(hf, f.name)
            want = tuple(want) if isinstance(want, list) else want
            assert getattr(ours, f.name) == want, f.name
    assert (ours.num_quantizers, ours.frame_rate, ours.samples_per_frame) == (
        hf.num_quantizers, hf.frame_rate, hf.hop_length)
    assert ours.lstm_size == 512 and ours.encoder_strides == (2, 4, 5, 8)


@pytest.mark.parametrize("kbps,books", [(1.5, 2), (3.0, 4), (6.0, 8), (12.0, 16), (24.0, 32)])
def test_bandwidth_to_books(kbps, books):
    from transformers.models.encodec.modeling_encodec import EncodecResidualVectorQuantizer

    cfg = EncodecConfig()
    assert cfg.books_for_bandwidth(kbps) == books
    rvq = EncodecResidualVectorQuantizer.__new__(EncodecResidualVectorQuantizer)
    rvq.codebook_size, rvq.frame_rate, rvq.num_quantizers = 1024, 75, 32
    assert rvq.get_num_quantizers_for_bandwidth(kbps) == books


@pytest.mark.parametrize("what", ["bf16", "tf32", "stream", "mesh", "shape"])
def test_refusals_at_construction(model, what):
    hf, cfg = model
    params = convert_hf_state_dict(hf.state_dict(), cfg)
    kw, ecfg = {}, EngineConfig()
    if what == "bf16":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    elif what == "tf32":
        cfg = dataclasses.replace(cfg, matmul_precision="high")
    elif what == "stream":
        ecfg = EngineConfig(long_audio_policy="stream")
    elif what == "mesh":
        kw["mesh"] = make_mesh(device="cpu")
    else:
        cfg = dataclasses.replace(cfg, normalize=True)
    with pytest.raises(ValueError, match="EnCodec|24 kHz"):
        MimiEncoderEngine(params, cfg, ecfg, num_codebooks=BOOKS, device="cpu", **kw)


@pytest.fixture(scope="module")
def snapshot(model, tmp_path_factory):
    from safetensors.torch import save_file

    hf, _ = model
    path = tmp_path_factory.mktemp("encodec_snapshot")
    hf.save_pretrained(str(path))
    if not (path / "model.safetensors").exists():
        save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
                  str(path / "model.safetensors"))
    assert json.loads((path / "config.json").read_text())["model_type"] == "encodec"
    return path


def test_codec_loads_a_snapshot_by_model_type(model, audios, snapshot):
    codec = MimiCodec.from_hf_dir(str(snapshot), num_codebooks=BOOKS, device="cpu")
    assert isinstance(codec.cfg, EncodecConfig) and codec.cfg.num_filters == 4
    a = audios[10]
    np.testing.assert_array_equal(codec.encode(a), hf_codes(model[0], a))
    s = codec.audio_to_str(a)
    assert len(s) == BOOKS * -(-len(a) // SPF)
    with pytest.raises(NotImplementedError, match="EnCodec"):
        codec.str_to_audio(s)


def test_cli_engine_from_a_snapshot(model, audios, snapshot):
    ap = argparse.ArgumentParser()
    cli.add_engine_args(ap)
    eng = cli.engine_from_args(ap.parse_args(["--device", "cpu", "--params", str(snapshot)]),
                               num_codebooks=BOOKS)
    assert isinstance(eng.cfg, EncodecConfig)
    a = audios[11]
    np.testing.assert_array_equal(eng.encode_chunk(a), hf_codes(model[0], a))
    with pytest.raises(ValueError, match="TF32"):
        cli.engine_from_args(ap.parse_args(["--device", "cpu", "--params", str(snapshot),
                                            "--precision", "high"]))
    with pytest.raises(ValueError, match="kernel only"):
        cli.engine_from_args(ap.parse_args(["--device", "cpu", "--params", str(snapshot),
                                            "--rvq-backend", "torch"]))


def test_lstm_apply_on_the_cpu_is_torch_lstm(model):
    """On a CPU tensor ``lstm_apply`` takes the plain version: the
    ``torch.lstm`` call over the frames, with the input added back, bit for
    bit (each utterance's codes equal transformers' through it)."""
    from tokenize_audio_tpu_torch.encodec import model as encodec_model
    from tokenize_audio_tpu_torch.encodec.weights import prepare

    hf, cfg = model
    params = prepare(convert_hf_state_dict(hf.state_dict(), cfg), cfg, BOOKS, "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, cfg.lstm_size, 41))
                         .astype(np.float32))
    h = x.permute(2, 0, 1)
    zeros = h.new_zeros((cfg.num_lstm_layers, 3, cfg.lstm_size))
    y = torch.lstm(h, (zeros, zeros), params["lstm"]["weights"], True, cfg.num_lstm_layers,
                   0.0, False, False, False)[0]
    assert torch.equal(encodec_model.lstm_apply(params["lstm"], cfg, x), (y + h).permute(1, 2, 0))
    assert "packed" not in params["lstm"]  # not the kernel's width: nothing to pack


def test_prepare_packs_the_lstm_kernel_layout():
    """At the published widths ``prepare`` packs the LSTM kernel's layout
    once; it unpacks to the checkpoint's four matrices exactly and to each
    layer's two biases summed, and a width the kernel does not run is
    refused."""
    from tokenize_audio_tpu_torch.encodec.weights import prepare
    from tokenize_audio_tpu_torch.ops.cuda import lstm as lstm_ops

    cfg = EncodecConfig()
    torch.manual_seed(1)
    lstm = torch.nn.LSTM(cfg.lstm_size, cfg.lstm_size, cfg.num_lstm_layers)
    params = {"enc_in": {}, "blocks": [], "enc_out": {},
              "lstm": {"weights": [getattr(lstm, n).detach() for n in encodec_weights.lstm_names(cfg)]},
              "rvq": {"embed": torch.zeros((cfg.num_quantizers, 4, cfg.codebook_dim))}}
    packed = prepare(params, cfg, 8, "cpu")["lstm"]["packed"]
    assert {k: tuple(v.shape) for k, v in packed.items()} == {
        "w_in0": (2048, 512), "b_in0": (2048,), "rec": (128, 48, 512), "b1": (2048,)}
    got = lstm_ops.unpack_weights(packed)
    w = dict(lstm.named_parameters())
    for name in ("w_ih0", "w_hh0", "w_ih1", "w_hh1"):
        kind, layer = name[:4], name[-1]
        assert torch.equal(got[name], w[f"weight_{kind[2:]}_l{layer}"].detach()), name
    for layer in (0, 1):
        assert torch.equal(got[f"b{layer}"], (w[f"bias_ih_l{layer}"] + w[f"bias_hh_l{layer}"]).detach())
    # the packed gate order puts each block's 16 rows together: block 1's
    # first row is unit 4's input gate, its fifth unit 4's forget gate
    assert torch.equal(packed["w_in0"][16], w["weight_ih_l0"][4].detach())
    assert torch.equal(packed["w_in0"][20], w["weight_ih_l0"][512 + 4].detach())
    with pytest.raises(ValueError, match="2 layers of 512"):
        lstm_ops.pack_weights([t[:64] for t in params["lstm"]["weights"]])


def test_the_lstm_wrapper_refuses_what_the_kernel_does_not_take(model):
    """Off the CPU the wrapper launches the kernel or raises: a device it
    does not know, a width other than 512, no packed weights."""
    from tokenize_audio_tpu_torch.ops.cuda import lstm as lstm_ops

    hf, cfg = model
    weights = convert_hf_state_dict(hf.state_dict(), cfg)["lstm"]["weights"]
    with pytest.raises(ValueError, match="CUDA or a CPU"):
        lstm_ops.lstm_residual(torch.zeros((1, 16, 4), device="meta"), weights, 2, None)
    launches = lstm_ops.lstm_residual.launches
    lstm_ops.lstm_residual(torch.zeros((1, 16, 4)), weights, 2, None)  # the plain version
    assert lstm_ops.lstm_residual.launches == launches


def test_engine_counts_lstm_launches_and_keeps_no_graphs(model, audios, monkeypatch):
    """The LSTM wrapper's count of kernel launches rises by none on the
    CPU and by one a batch where the wrapper launches (here a stand-in
    that counts as the kernel does), and an EnCodec engine keeps no CUDA
    graph cache even on a CUDA device."""
    from tokenize_audio_tpu_torch.ops.cuda import lstm as lstm_ops

    eng = engine(model)
    launches = lstm_ops.lstm_residual.launches
    want = eng.encode_batch(audios)
    assert lstm_ops.lstm_residual.launches == launches and eng.stats.batches > 0
    plain = lstm_ops.lstm_residual

    def counting(*args, **kwargs):
        counting.launches += 1
        return plain(*args, **kwargs)

    counting.launches = 0
    monkeypatch.setattr(lstm_ops, "lstm_residual", counting)
    eng = engine(model)
    for g, w in zip(eng.encode_batch(audios), want):
        np.testing.assert_array_equal(g, w)
    s = eng.stats.as_dict()
    assert "lstm_launches" not in s
    assert s["batches"] == counting.launches > 0
    assert s["transformer_graph_captures"] == s["transformer_graph_replays"] == 0
    eng.device = torch.device("cuda", 0)
    assert eng._new_graphs() is None


def test_lstm_steps_and_ranges(model, audios):
    """``lstm_steps`` counts each batch's padded frames a row times the
    layers; the encode's stages sit in ``tokenize_audio::encodec.*``
    ranges while a profiler records."""
    eng = engine(model)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.encode_batch(audios[:6])
    stats = eng.stats.as_dict()
    # six rows under the 0.25 s bucket (6000 samples): two batches of 750 frames
    assert stats["batches"] == 2 and stats["lstm_steps"] == 2 * 750 * 2
    names = {e.name for e in prof.events()}
    for stage in ("seanet_encode", "lstm", "project", "rvq", "pack"):
        assert f"tokenize_audio::encodec.{stage}" in names
    assert not any(n.startswith("tokenize_audio::mimi.") for n in names)
