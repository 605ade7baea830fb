"""PyTorch port, EnCodec's LSTM kernel (``ops/cuda/lstm.py``,
``csrc/lstm.cu``): on the CPU, the packed layout read as the kernel reads
it (each thread's register weights, the warps' partial sums, the cell in
the packed gate order) gives the plain version's output; on the card, the
kernel against the plain version at the engine's row and frame counts, its
launch count and refusals, the engine's codes against cuDNN's path over the
same batches, and a Mimi engine that never builds the kernel. The file
imports no JAX, so its card cases run with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_lstm.py

where each asks for the ``cuda`` fixture, which skips it without a CUDA
device."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tokenize_audio_tpu_torch.ops.cuda import lstm as lstm_ops

ROOT = Path(__file__).resolve().parents[1]
H = lstm_ops.HIDDEN


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_weights(seed: int, device="cpu"):
    """torch.lstm's 8 tensors for 2 layers of 512, scaled as the benchmark's
    weights are (port_bench/reference/encodec_weights.py): matrices by
    1/sqrt(fan_in), biases at unit scale."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(2):
        out += [torch.randn((4 * H, H), generator=g) / H**0.5,
                torch.randn((4 * H, H), generator=g) / H**0.5,
                torch.randn((4 * H,), generator=g), torch.randn((4 * H,), generator=g)]
    return [w.to(device) for w in out]


def kernel_model(x, packed):
    """csrc/lstm.cu's arithmetic on the CPU, read from the packed layout as
    its threads read it, summed in float64 (the order is the card's
    business): x (B, H, T) -> lstm(x) + x."""
    b, _, t = x.shape
    rec = packed["rec"].double()  # (block, j, thread)
    tid = torch.arange(lstm_ops.THREADS)
    warp, rg, kg = tid // 32, (tid % 32) // 4, tid % 4
    k = (warp * 32 + kg * 8)[:, None] + torch.arange(8)[None, :]  # (thread, 8)
    gx = torch.addmm(packed["b_in0"], x.permute(2, 0, 1).reshape(t * b, H),
                     packed["w_in0"].t()).reshape(t, b, 4 * H).double()
    h0, h1 = torch.zeros(b, H, dtype=torch.float64), torch.zeros(b, H, dtype=torch.float64)
    c = torch.zeros(2, b, H, dtype=torch.float64)
    out = torch.empty_like(x)
    # a thread's part p sums into its block's gate row rg + 8 (p % 2) of
    # layer p // 2 (as the kernel's transposing shuffle sends it)
    rows = [(p // 2) * 16 + rg + 8 * (p % 2) for p in range(4)]
    for s in range(t + 1):
        hv0, hv1 = h0[:, k], h1[:, k]  # (B, thread, 8)
        part = [torch.einsum("ljt,btj->blt", rec[:, 8 * p:8 * p + 8], hv0) for p in range(4)]
        part[2] = part[2] + torch.einsum("ljt,btj->blt", rec[:, 32:40], hv1)
        part[3] = part[3] + torch.einsum("ljt,btj->blt", rec[:, 40:48], hv1)
        gates = torch.zeros(b, lstm_ops.BLOCKS, 32, dtype=torch.float64)
        for p in range(4):
            gates.index_add_(2, rows[p], part[p])
        new = []
        for layer, inp in ((0, gx[min(s, t - 1)].reshape(b, lstm_ops.BLOCKS, 16)),
                           (1, packed["b1"].double().reshape(1, lstm_ops.BLOCKS, 16))):
            g = (gates[:, :, 16 * layer:16 * layer + 16] + inp).reshape(b, lstm_ops.BLOCKS, 4, 4)
            i, f, gg, o = torch.sigmoid(g[:, :, 0]), torch.sigmoid(g[:, :, 1]), torch.tanh(
                g[:, :, 2]), torch.sigmoid(g[:, :, 3])
            cn = f * c[layer].reshape(b, lstm_ops.BLOCKS, 4) + i * gg
            new.append((cn.reshape(b, H), (o * torch.tanh(cn)).reshape(b, H)))
        if s < t:  # layer 0 at frame s
            c[0], h0_next = new[0]
        if s >= 1:  # layer 1 at frame s - 1, from h0[s - 1]
            c[1], h1 = new[1]
            out[:, :, s - 1] = (h1 + x[:, :, s - 1].double()).float()
        if s < t:
            h0 = h0_next
    return out


def test_packed_layout_as_the_kernel_reads_it_gives_the_plain_lstm():
    """What each of the kernel's threads holds, and where its sums go, make
    the plain version's LSTM: to float32 rounding at two layers of 512."""
    weights = random_weights(0)
    packed = lstm_ops.pack_weights(weights)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, H, 6)).astype(np.float32))
    want = lstm_ops.lstm_residual_reference(x, weights, 2)
    got = kernel_model(x, packed)
    assert float((got - want).abs().max()) < 1e-5


# the engine's row counts in engine-web.encodec-8cb (1-24) and its largest
# batch, at frame counts from one to the cell's longest single-row batch
ROWS = [1, 3, 5, 16, 24, 128]
FRAMES = [1, 2, 150, 4938]
# the kernel and cuDNN sum 512-1536 float32 products a gate in other orders:
# about 1e-6 apart a step, which the forget gate (< 1) keeps from growing
# over the frames; outputs are h (|h| < 1) plus x
ATOL = 5e-5


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("frames", FRAMES)
def test_lstm_kernel_close_to_plain(cuda, rows, frames):
    weights = random_weights(rows, cuda)
    packed = lstm_ops.pack_weights(weights)
    g = torch.Generator(device=cuda).manual_seed(frames)
    x = torch.randn((rows, H, frames), generator=g, device=cuda)
    got = lstm_ops.lstm_residual(x, weights, 2, packed)
    want = lstm_ops.lstm_residual_reference(x, weights, 2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= ATOL, err


def test_lstm_kernel_counts_and_refuses(cuda):
    """One launch a call, and one a block of ``MAX_ROWS`` rows past that; a
    wrong packing, another width or another dtype raises before any
    launch."""
    weights = random_weights(1, cuda)
    packed = lstm_ops.pack_weights(weights)
    x = torch.randn((2, H, 7), device=cuda)
    n = lstm_ops.lstm_residual.launches
    a = lstm_ops.lstm_residual(x, weights, 2, packed)
    b = lstm_ops.lstm_residual(x, weights, 2, packed)
    torch.cuda.synchronize()
    assert lstm_ops.lstm_residual.launches == n + 2
    assert torch.equal(a, b)  # a fixed summation order
    cpu = lstm_ops.pack_weights([w.cpu() for w in weights])
    for bad in (None, cpu, {**packed, "rec": packed["rec"][:64]}):
        with pytest.raises(ValueError, match="packed"):
            lstm_ops.lstm_residual(x, weights, 2, bad)
    with pytest.raises(ValueError, match="2 layers of 512"):
        lstm_ops.lstm_residual(x[:, :256], weights, 2, packed)
    with pytest.raises(TypeError, match="float32"):
        lstm_ops.lstm_residual(x.double(), weights, 2, packed)
    assert lstm_ops.lstm_residual.launches == n + 2
    # more rows than a launch takes go in blocks of MAX_ROWS
    x = torch.randn((lstm_ops.MAX_ROWS + 3, H, 3), device=cuda)
    got = lstm_ops.lstm_residual(x, weights, 2, packed)
    want = lstm_ops.lstm_residual_reference(x, weights, 2)
    torch.cuda.synchronize()
    assert lstm_ops.lstm_residual.launches == n + 4
    assert float((got - want).abs().max()) <= ATOL


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "port_bench" / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_engine_codes_with_the_kernel_match_cudnn(cuda, monkeypatch):
    """The published widths on the card with the benchmark's seeded weights,
    a web-like mix of 1-30 s utterances in 192 s batches of 1-24 rows: one
    launch a batch, and the codes against the same engine's with cuDNN's
    ``torch.lstm`` (the plain version) over the same batches, at least 0.999
    of frames equal and every first divergence a near-tie of the RVQ input
    cuDNN's path gave."""
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.encodec import model as encodec_model
    from tokenize_audio_tpu_torch.encodec.config import EncodecConfig
    from tokenize_audio_tpu_torch.encodec.weights import convert_hf_state_dict
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    cfg_d = json.loads((ROOT / "port_bench" / "configs" / "encodec-24k-8cb.json").read_text())
    cfg = EncodecConfig()
    sd = _load("encodec_weights").state_dict(cfg_d, 2**31 + 7, cuda)
    ecfg = EngineConfig(batch_size=16, samples_per_batch=192 * 24_000, max_batch_size=128,
                        min_bucket_seconds=2.0, bucket_growth=1.15)
    rng = np.random.default_rng(11)
    secs = np.clip(rng.lognormal(1.9, 0.8, 48), 0.8, 30.0)
    audios = [(rng.standard_normal(int(s * 24_000)) * 0.3 * 32767).astype(np.int16) for s in secs]

    def run():
        seen = []
        inner = encodec_model.rvq_encode

        def spy(params, x, k):
            codes = inner(params, x, k)
            b, d, t = x.shape
            seen.append((x.transpose(1, 2).reshape(b * t, d), codes.transpose(1, 2).reshape(b * t, k)))
            return codes

        monkeypatch.setattr(encodec_model, "rvq_encode", spy)
        eng = MimiEncoderEngine(convert_hf_state_dict(sd, cfg), cfg, ecfg, num_codebooks=8,
                                device=cuda)
        codes = eng.encode_batch(audios)
        torch.cuda.synchronize()
        monkeypatch.setattr(encodec_model, "rvq_encode", inner)
        return eng, codes, seen

    eng, got, got_seen = run()
    s = eng.stats.as_dict()
    assert s["lstm_launches"] == s["batches"] > 1
    embeds = eng.params["rvq"]["embed"]

    def cudnn(x, weights, layers, packed):
        return lstm_ops.lstm_residual_reference(x, weights, layers)

    cudnn.launches = 0  # the count the engine reads
    monkeypatch.setattr(lstm_ops, "lstm_residual", cudnn)
    eng, want, want_seen = run()
    assert eng.stats.lstm_launches == 0
    equal = sum(int((g == w).all(axis=0).sum()) for g, w in zip(got, want))
    frames = sum(w.shape[1] for w in want)
    assert equal >= 0.999 * frames, (equal, frames)
    for (_, g), (x, w) in zip(got_seen, want_seen, strict=True):
        _, margins, _ = rvq.first_divergence_margins(x, embeds, g, w)
        assert max(margins, default=0.0) < 1e-6


MIMI_CHILD = """
import json, numpy as np, torch
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.ops.cuda import _build
cfg = MimiConfig(num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
                 num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
                 codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
                 upsample_groups=32)
eng = MimiEncoderEngine(random_params(cfg, seed=0), cfg, num_codebooks=8, device="cuda")
eng.encode_batch([np.zeros(24_000, np.float32), np.ones(5_000, np.float32)])
torch.cuda.synchronize()
print(json.dumps({"libs": sorted(_build._libs), "lstm_launches": eng.stats.lstm_launches}))
"""


def test_a_mimi_engine_never_builds_the_lstm_kernel(cuda):
    """A process that runs only Mimi loads its two kernels and not the LSTM's."""
    out = subprocess.run([sys.executable, "-c", MIMI_CHILD], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"libs": ["rvq", "seanet_resblock"], "lstm_launches": 0}
