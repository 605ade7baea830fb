"""PyTorch port, EnCodec's fused resnet block + ELU (``ops/cuda/
encodec_resblock.py``, ``csrc/encodec_resblock.cu``): on the CPU, the plain
version and ``seanet_encode`` against the chain the model ran before the
kernel (three convs, ELUs, the add and the mask), bit for bit; the packed
layout read as the kernel reads it (tile by tile, the reflect halo at
t = 0) gives the plain version; the wrapper's and the configuration's
refusals. On the card, the kernel against the plain version at the
engine-web.encodec-8cb cell's stage shapes, its launch count and
refusals, the engine's codes against the cuDNN chain over the same
batches, and a Mimi engine that never builds the kernel. The file imports
no JAX, so its card cases run with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_encodec_resblock.py

where each asks for the ``cuda`` fixture, which skips it without a CUDA
device."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import ieee_fp32
from tokenize_audio_tpu_torch.encodec import model as encodec_model
from tokenize_audio_tpu_torch.encodec.config import EncodecConfig
from tokenize_audio_tpu_torch.encodec.weights import convert_hf_state_dict, prepare
from tokenize_audio_tpu_torch.ops.cuda import encodec_resblock as rb

ROOT = Path(__file__).resolve().parents[1]
# two strides (8 samples a frame) and narrow channels, as tests/test_torch_encodec.py
TINY = dict(num_filters=4, hidden_size=16, upsampling_ratios=[4, 2], codebook_size=64,
            target_bandwidths=[18.0, 36.0, 72.0, 144.0, 216.0])
# time columns a tile (csrc/encodec_resblock.cu: TT = 8192 / C)
TILE = {32: 256, 64: 128, 128: 64, 256: 32}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the parallel test runner shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "port_bench" / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encoder_params(cfg: EncodecConfig, seed: int, device="cpu"):
    """The benchmark's seeded weights (port_bench/reference/encodec_weights.py)
    for ``cfg``, through the program's converter."""
    sd = _load("encodec_weights").state_dict(dataclasses.asdict(cfg), seed, device)
    return convert_hf_state_dict(sd, cfg)


def parent_seanet_encode(params, cfg, x, valid):
    """``seanet_encode`` as the model ran it before the resblock kernel."""
    conv, mask = encodec_model.causal_conv1d, encodec_model._mask
    x, valid = conv(x, valid, params["enc_in"]["w"], params["enc_in"]["b"])
    for block, stride in zip(params["blocks"], cfg.encoder_strides):
        for j, res in enumerate(block["res"]):
            h, _ = conv(F.elu(x), None, res["c1"]["w"], res["c1"]["b"],
                        dilation=cfg.dilation_growth_rate**j)
            h, _ = conv(F.elu(h), None, res["c2"]["w"], res["c2"]["b"])
            sc = res.get("shortcut")
            if sc is not None:
                x, _ = conv(x, None, sc["w"], sc["b"])
            x = mask(x + h, valid)
        x, valid = conv(F.elu(x), valid, block["down"]["w"], block["down"]["b"], stride=stride)
    return x, valid


def block_weights(res):
    return (res["c1"]["w"], res["c1"]["b"], res["c2"]["w"], res["c2"]["b"],
            res["shortcut"]["w"], res["shortcut"]["b"])


def masked_audio(lengths, t, seed):
    """(B, 1, t) float32 audio, zero past each row's length (the masked
    invariant ``encode`` starts from), and the int32 lengths."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((len(lengths), 1, t)) * 0.3).astype(np.float32)
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0.0
    return torch.from_numpy(x), torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("kw", [{}, TINY], ids=["published", "tiny"])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_version_and_seanet_encode_are_the_parent_chain(kw, masked):
    """On the CPU each stage's plain version, and the whole of
    ``seanet_encode``, give the parent's chain to the bit."""
    cfg = EncodecConfig(**kw)
    params = encoder_params(cfg, 5)
    t = 40 * cfg.samples_per_frame
    x, valid = masked_audio([t, t // 2 - 5, 1], t, 3)
    if not masked:
        valid = None
    want, want_valid = parent_seanet_encode(params, cfg, x, valid)
    with torch.no_grad():
        got, got_valid = encodec_model.seanet_encode(params, cfg, x, valid)
    assert torch.equal(got, want)
    assert (got_valid is None and want_valid is None) or torch.equal(got_valid, want_valid)
    # stage by stage: the parent's block, mask and ELU against the wrapper
    h, v = encodec_model.causal_conv1d(x, valid, params["enc_in"]["w"], params["enc_in"]["b"])
    launches = rb.resblock_elu.launches
    for block, stride in zip(params["blocks"], cfg.encoder_strides):
        res = block["res"][0]
        w3, b3, w1, b1, wsc, bsc = block_weights(res)
        a, _ = encodec_model.causal_conv1d(F.elu(h), None, w3, b3)
        a, _ = encodec_model.causal_conv1d(F.elu(a), None, w1, b1)
        sc, _ = encodec_model.causal_conv1d(h, None, wsc, bsc)
        parent = F.elu(encodec_model._mask(sc + a, v))
        got = rb.resblock_elu(h, v, *block_weights(res))
        assert torch.equal(got, parent)
        assert torch.equal(rb.resblock_elu_reference(h, v, *block_weights(res)), parent)
        h, v = encodec_model.causal_conv1d(got, v, block["down"]["w"], block["down"]["b"],
                                           stride=stride)
    assert rb.resblock_elu.launches == launches  # the CPU launches nothing


def kernel_model(x, valid, packed):
    """csrc/encodec_resblock.cu's arithmetic on the CPU, read from the packed
    layout as its threads read it, tile by tile (the halo of the tile at
    t = 0 is columns 2 and 1, of every other tile its previous two
    columns), summed in float64 (the order is the card's business)."""
    b, c, t = x.shape
    w3, wy = packed["w3"].double(), packed["wy"].double()  # (C, 3, C2), (C + C2, C)
    b3, by = packed["b3"].double()[None, :, None], packed["by"].double()[None, :, None]
    e, xd = F.elu(x.double()), x.double()
    out = torch.empty_like(x)
    vb = torch.full((b,), t) if valid is None else valid.long()
    for t0 in range(0, t, TILE[c]):
        n = min(TILE[c], t - t0)
        halo = [2, 1] if t0 == 0 else [t0 - 2, t0 - 1]
        ex = torch.cat([e[:, :, halo], e[:, :, t0:t0 + n]], dim=2)
        h = sum(torch.einsum("cm,bcn->bmn", w3[:, k], ex[:, :, k:k + n]) for k in range(3))
        h = F.elu(h + b3)
        y = (torch.einsum("cm,bcn->bmn", wy[:c], xd[:, :, t0:t0 + n])
             + torch.einsum("jm,bjn->bmn", wy[c:], h) + by)
        pos = torch.arange(t0, t0 + n)[None, None, :]
        out[:, :, t0:t0 + n] = torch.where(pos < vb[:, None, None], F.elu(y), 0.0).float()
    return out


@pytest.mark.parametrize("c,t", [(32, 600), (64, 257), (128, 130), (256, 67), (256, 3)])
def test_packed_layout_as_the_kernel_reads_it_gives_the_plain_version(c, t):
    """What the kernel reads of ``pack_weights``'s layout, where it reads
    it, makes the plain version's block: to float32 rounding, over ragged
    tiles, rows past and under the reflect halo, and no mask."""
    cfg = EncodecConfig()
    params = prepare(encoder_params(cfg, 7), cfg, 8, "cpu")
    res = params["blocks"][(32, 64, 128, 256).index(c)]["res"][0]
    rng = np.random.default_rng(c + t)
    x = torch.from_numpy((rng.standard_normal((3, c, t)) * 0.5).astype(np.float32))
    valid = torch.tensor([t, max(t - 40, 2), 1], dtype=torch.int32)
    for i, n in enumerate(valid.tolist()):
        x[i, :, n:] = 0.0
    for v in (valid, None):
        want = rb.resblock_elu_reference(x, v, *block_weights(res))
        got = kernel_model(x, v, res["packed"])
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_prepare_packs_each_block_once():
    """``prepare`` keeps each stage's block in the kernel's layout beside its
    weights; another block form keeps none (it does not run on the card)."""
    cfg = EncodecConfig(**TINY)
    params = encoder_params(cfg, 1)
    tree = prepare(params, cfg, 8, "cpu")
    for block in tree["blocks"]:
        res = block["res"][0]
        want = rb.pack_weights(*block_weights(res))
        assert res["packed"].keys() == want.keys()
        assert all(torch.equal(res["packed"][k], want[k]) for k in want)
        c = res["c2"]["w"].shape[0]
        assert res["packed"]["wy"].shape == (c + c // 2, c)
    two = EncodecConfig(**TINY, num_residual_layers=2)
    tree = prepare(encoder_params(two, 1), two, 8, "cpu")
    assert all("packed" not in r for block in tree["blocks"] for r in block["res"])


def test_wrapper_refuses_a_wrong_device_dtype_or_shape():
    cfg = EncodecConfig()
    res = encoder_params(cfg, 2)["blocks"][0]["res"][0]
    w = list(block_weights(res))
    x = torch.zeros((2, 32, 40))
    valid = torch.tensor([40, 3], dtype=torch.int32)
    launches = rb.resblock_elu.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        rb.resblock_elu(x.to("meta"), valid, *w)
    with pytest.raises(ValueError, match="one CUDA device"):
        rb.resblock_elu(*(a.to("meta") for a in (x, valid, *w)))
    with pytest.raises(TypeError, match="float32"):
        rb.resblock_elu(x.double(), valid, *w)
    with pytest.raises(TypeError, match="float32"):
        rb.resblock_elu(x, valid, *w[:4], w[4].double(), w[5])
    with pytest.raises(ValueError, match=r"x \(B, C, T\)"):
        rb.resblock_elu(x[0], valid, *w)
    with pytest.raises(ValueError, match="wants valid"):
        rb.resblock_elu(x, valid[:1], *w)
    # another block form: a k5 conv, no shortcut (a k1 conv to C/2 in its
    # place), a conv to a quarter of the channels
    k5 = torch.zeros((16, 32, 5))
    with pytest.raises(ValueError, match="wants valid"):
        rb.resblock_elu(x, valid, k5, *w[1:])
    with pytest.raises(ValueError, match="wants valid"):
        rb.resblock_elu(x, valid, *w[:4], torch.zeros((16, 32, 1)), w[5])
    with pytest.raises(ValueError, match="wants valid"):
        rb.resblock_elu(x, valid, torch.zeros((8, 32, 3)), torch.zeros(8), *w[2:])
    assert rb.resblock_elu.launches == launches


@pytest.mark.parametrize("kw,why", [
    ({"num_residual_layers": 2}, "one resnet block a stage"),
    ({"use_conv_shortcut": False}, "conv shortcut"),
    ({"residual_kernel_size": 5}, "k3 conv"),
    ({"compress": 4}, "k3 conv"),
    (TINY, "stage widths"),
])
def test_the_card_refuses_another_block_form(kw, why):
    """A form the resblock kernel does not run is refused for a CUDA device
    by name, and runs on the CPU."""
    cfg = EncodecConfig(**kw)
    with pytest.raises(ValueError, match=f"EnCodec on the card: .*{why}"):
        encodec_model.check_modes(cfg, "cuda")
    with pytest.raises(ValueError, match=why):
        encodec_model.check_modes(cfg, torch.device("cuda", 0))
    encodec_model.check_modes(cfg, "cpu")
    encodec_model.check_modes(cfg)
    encodec_model.check_modes(EncodecConfig(), "cuda")


def test_another_form_runs_on_the_cpu_as_before():
    """Two blocks a stage (dilation 1, 2) run the parent's chain on the CPU."""
    cfg = EncodecConfig(**TINY, num_residual_layers=2)
    params = encoder_params(cfg, 4)
    x, valid = masked_audio([400, 123], 400, 8)
    want, _ = parent_seanet_encode(params, cfg, x, valid)
    with torch.no_grad():
        got, _ = encodec_model.seanet_encode(params, cfg, x, valid)
    assert torch.equal(got, want)


# The engine-web.encodec-8cb cell's stage shapes (rows, samples at C = 32;
# stage s has C = 32 * 2^s at T / (1, 2, 8, 40)): its 24-row, 12-row and
# longest 1-row batches, and ragged or short lengths around the tiles.
CELL_BATCHES = [(24, 111_040), (12, 48_000), (1, 1_440_000)]
STAGES = [(32, 1), (64, 2), (128, 8), (256, 40)]
CARD_CASES = [(b, c, t // d) for b, t in CELL_BATCHES for c, d in STAGES] + [
    (3, 32, 3), (3, 32, 255), (4, 32, 513), (3, 64, 129), (4, 64, 4001),
    (3, 128, 65), (4, 128, 999), (3, 256, 31), (3, 256, 33), (4, 256, 2778),
]


@pytest.mark.parametrize("b,c,t", CARD_CASES)
def test_kernel_close_to_plain(cuda, b, c, t):
    """The kernel against the plain version (cuDNN in IEEE fp32): within
    1e-5 of the plain block's largest magnitude, with zeros past each
    row's valid length. Rows: full, one sample and two (under the reflect
    halo), empty, and random lengths."""
    cfg = EncodecConfig()
    params = prepare(encoder_params(cfg, c + b, cuda), cfg, 8, cuda)
    res = params["blocks"][(32, 64, 128, 256).index(c)]["res"][0]
    g = torch.Generator(device=cuda).manual_seed(t)
    x = torch.randn((b, c, t), generator=g, device=cuda) * 0.5
    valid = torch.randint(0, t + 1, (b,), generator=g, device=cuda, dtype=torch.int32)
    valid[: min(b, 4)] = torch.tensor([t, 1, 2, 0][: min(b, 4)], dtype=torch.int32)
    pos = torch.arange(t, device=cuda)
    x = torch.where(pos < valid[:, None, None], x, 0.0)
    launches = rb.resblock_elu.launches
    got = rb.resblock_elu(x, valid, *block_weights(res), packed=res["packed"])
    assert rb.resblock_elu.launches == launches + 1
    with ieee_fp32():
        want = rb.resblock_elu_reference(x, valid, *block_weights(res))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    for i, n in enumerate(valid.tolist()):
        assert bool((got[i, :, n:] == 0).all())


def test_kernel_counts_and_refuses(cuda):
    """One launch a call, a fixed summation order, packing at the launch
    when none is passed, and refusals before any launch: mixed devices, an
    int64 valid, another width, T under the halo, a wrong packing."""
    cfg = EncodecConfig()
    res = prepare(encoder_params(cfg, 3, cuda), cfg, 8, cuda)["blocks"][1]["res"][0]
    w = block_weights(res)
    x = torch.randn((2, 64, 300), device=cuda)
    valid = torch.tensor([300, 100], dtype=torch.int32, device=cuda)
    x[1, :, 100:] = 0.0
    n = rb.resblock_elu.launches
    a = rb.resblock_elu(x, valid, *w, packed=res["packed"])
    b = rb.resblock_elu(x, valid, *w)  # packs at the launch
    c = rb.resblock_elu(x, None, *w, packed=res["packed"])
    torch.cuda.synchronize()
    assert rb.resblock_elu.launches == n + 3
    assert torch.equal(a, b)
    assert torch.equal(a[0], c[0])  # the full row; row 1 unmasked differs
    with pytest.raises(ValueError, match="one CUDA device"):
        rb.resblock_elu(x, valid.cpu(), *w)
    with pytest.raises(TypeError, match="int32"):
        rb.resblock_elu(x, valid.long(), *w)
    with pytest.raises(ValueError, match="T >= 3"):
        rb.resblock_elu(x[:, :, :2].contiguous(), valid, *w)
    cpu = rb.pack_weights(*(t.cpu() for t in w))
    for bad in (cpu, {**res["packed"], "wy": res["packed"]["wy"][:64]}):
        with pytest.raises(ValueError, match="packed"):
            rb.resblock_elu(x, valid, *w, packed=bad)
    tiny = EncodecConfig(**TINY)
    tres = prepare(encoder_params(tiny, 3), tiny, 8, cuda)["blocks"][0]["res"][0]
    with pytest.raises(ValueError, match="takes C in"):
        rb.resblock_elu(torch.zeros((1, 4, 64), device=cuda), None, *block_weights(tres))
    assert rb.resblock_elu.launches == n + 3


def test_engine_codes_with_the_kernel_match_the_cudnn_chain(cuda, monkeypatch):
    """The published widths on the card with the benchmark's seeded weights,
    a web-like mix of 1-30 s utterances in 192 s batches of 1-24 rows: four
    launches a batch (one a stage), and the codes against the same engine's
    with the plain version (cuDNN's convs and PyTorch's elementwise passes,
    the parent's chain) over the same batches, at least 0.999 of frames
    equal and every first divergence a near-tie of the RVQ input the
    chain gave."""
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    cfg_d = json.loads((ROOT / "port_bench" / "configs" / "encodec-24k-8cb.json").read_text())
    cfg = EncodecConfig()
    sd = _load("encodec_weights").state_dict(cfg_d, 2**31 + 11, cuda)
    ecfg = EngineConfig(batch_size=16, samples_per_batch=192 * 24_000, max_batch_size=128,
                        min_bucket_seconds=2.0, bucket_growth=1.15)
    rng = np.random.default_rng(13)
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
        launches = rb.resblock_elu.launches
        codes = eng.encode_batch(audios)
        torch.cuda.synchronize()
        monkeypatch.setattr(encodec_model, "rvq_encode", inner)
        return eng, codes, seen, rb.resblock_elu.launches - launches

    eng, got, got_seen, launches = run()
    assert launches == 4 * eng.stats.batches and eng.stats.batches > 1
    embeds = eng.params["rvq"]["embed"]

    def chain(x, valid, *weights, packed=None):
        return rb.resblock_elu_reference(x, valid, *weights)

    chain.launches = 0  # the kernel's count, which the plain chain never raises
    monkeypatch.setattr(rb, "resblock_elu", chain)
    eng, want, want_seen, launches = run()
    assert launches == 0
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
from tokenize_audio_tpu_torch.ops.cuda import _build, encodec_resblock
cfg = MimiConfig(num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
                 num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
                 codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
                 upsample_groups=32)
eng = MimiEncoderEngine(random_params(cfg, seed=0), cfg, num_codebooks=8, device="cuda")
eng.encode_batch([np.zeros(24_000, np.float32), np.ones(5_000, np.float32)])
torch.cuda.synchronize()
print(json.dumps({"libs": sorted(_build._libs),
                  "launches": encodec_resblock.resblock_elu.launches}))
"""


def test_a_mimi_engine_never_builds_the_encodec_resblock_kernel(cuda):
    """A process that runs only Mimi loads its two kernels and not EnCodec's
    resblock kernel."""
    out = subprocess.run([sys.executable, "-c", MIMI_CHILD], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"libs": ["rvq", "seanet_resblock"], "launches": 0}
