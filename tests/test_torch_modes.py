"""PyTorch port, precision modes on the tiny oracle config, on the CPU:
``matmul_precision="high"``/``"default"`` (TF32 on the card) and
``compute_dtype="bfloat16"`` against the JAX package's same modes, the
TF32 flags at every conv and matmul launch site (each site in the mode the
JAX package gives it), and ``config.fp32_precision`` across threads."""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tokenize_audio_tpu.mimi.model as jax_model
from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu_torch.config import EngineConfig, fp32_precision, ieee_fp32
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import encode, params_from_torch_model, params_to_torch
from tokenize_audio_tpu_torch.mimi import model
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf
from tokenize_audio_tpu_torch.ops.cuda import rvq as rvq_ops

SPF = 1920
K = 12
LENGTHS = [6 * SPF, 3 * SPF + 311, 5 * SPF - 7]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's many small CPU encodes on one torch thread: under
    the parallel test runner the cores are shared by several workers, and
    each tiny op's wait on its sibling threads costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle():
    hf, jparams, jcfg = make_oracle(tiny_hf_config())
    cfg = config_from_hf(hf.config)
    params = params_to_torch(params_from_torch_model(hf), "cpu")
    return jparams, jcfg, params, cfg


def ragged(seed=1):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(LENGTHS), 6 * SPF), np.float32)
    for i, n in enumerate(LENGTHS):
        audio[i, :n] = rng.standard_normal(n) * 0.3
    return audio


def port_encode(params, cfg, audio, **kw):
    codes, valid = encode(params, cfg, torch.from_numpy(audio),
                          torch.tensor(LENGTHS, dtype=torch.int32), num_quantizers=K, **kw)
    return codes.numpy(), valid.tolist()


def jax_encode(jparams, jcfg, audio, **kw):
    codes, valid = jax_model.encode(jparams, jcfg, jnp.asarray(audio), jnp.asarray(LENGTHS),
                                    num_quantizers=K, **kw)
    return np.asarray(codes), np.asarray(valid).tolist()


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("level", ["high", "default"])
def test_tf32_levels_equal_jax_and_parity_on_the_cpu(oracle, level, backend):
    """XLA:CPU ignores ``precision`` and the CPU ignores the TF32 flags, so
    port-``level`` codes equal JAX-``level`` codes and both equal parity
    (16 -> 24 kHz fused resample included)."""
    jparams, jcfg, params, cfg = oracle
    audio = ragged()
    pcfg = dataclasses.replace(cfg, matmul_precision=level, rvq_backend=backend,
                               seanet_backend=backend)
    got, got_v = port_encode(params, pcfg, audio)
    want, want_v = jax_encode(jparams, dataclasses.replace(jcfg, matmul_precision=level), audio)
    parity, _ = port_encode(params, cfg, audio)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, parity)
    assert got_v == want_v
    got16, _ = port_encode(params, pcfg, audio, resample=(3, 2))
    np.testing.assert_array_equal(got16, port_encode(params, cfg, audio, resample=(3, 2))[0])


def test_unknown_levels_raise(oracle):
    _, _, params, cfg = oracle
    audio = torch.zeros((1, SPF))
    with pytest.raises(ValueError, match="matmul_precision"):
        encode(params, dataclasses.replace(cfg, matmul_precision="medium"), audio)
    with pytest.raises(ValueError, match="compute_dtype"):
        encode(params, dataclasses.replace(cfg, compute_dtype="float16"), audio)
    with pytest.raises(ValueError, match="fp32 precision mode"):
        with fp32_precision("bf16"):
            pass


# bf16 keeps 8 significant bits (unit roundoff 2^-8). The port and the JAX
# package round at different points along the tiny model's ~30 chained
# bf16 ops, so their pre-RVQ latents may differ by several bf16 ulps of the
# largest value: the bar is 16 ulps, 2^-4 of max|JAX latent| (the float32
# modes agree to 1e-6 of it).
BF16_LATENT_RTOL = 2.0**-4


def test_bf16_latent_close_to_jax_and_codes_match_parity(oracle, monkeypatch):
    """Port-bf16's pre-RVQ latent is within BF16_LATENT_RTOL of JAX-bf16's
    (JAX run op by op so its latent can be read), and its codes match
    parity's above the JAX package's own bar (> 0.4,
    tests/test_mimi_parity.py::test_bf16_fast_mode_runs_and_is_close)."""
    jparams, jcfg, params, cfg = oracle
    audio = ragged(2)
    seen = {}
    for mod, key in ((jax_model, "jax"), (model, "port")):
        real = mod.split_rvq_encode

        def spy(p, x, *a, _real=real, _key=key, **k):
            seen[_key] = np.asarray(x)
            return _real(p, x, *a, **k)

        monkeypatch.setattr(mod, "split_rvq_encode", spy)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    got, got_v = port_encode(params, bf16, audio)
    with jax.disable_jit():
        want, want_v = jax_encode(jparams, dataclasses.replace(jcfg, compute_dtype="bfloat16"),
                                  audio)
    assert seen["port"].dtype == seen["jax"].dtype == np.float32  # RVQ input is f32
    err = float(np.abs(seen["port"] - seen["jax"]).max())
    assert err <= BF16_LATENT_RTOL * float(np.abs(seen["jax"]).max()), err
    assert got_v == want_v
    parity, _ = port_encode(params, cfg, audio)
    assert (got == parity).mean() > 0.4
    assert (np.asarray(want) == parity).mean() > 0.4


def test_bf16_keeps_its_f32_islands(oracle, monkeypatch):
    """In bf16 mode the model's convs and projections take bf16 weights,
    while LayerNorm, softmax, the RoPE tables, the resample, the quantizer
    in_proj and the RVQ run in f32 (JAX model.py:247-252, 282-297, 365-370,
    472, 487)."""
    _, _, params, cfg = oracle
    seen = []

    def spy(mod, name, record):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            out = real(*a, **k)
            seen.append((name, record(a, k, out)))
            return out

        monkeypatch.setattr(mod, name, wrapped)

    spy(F, "layer_norm", lambda a, k, out: a[0].dtype)
    spy(F, "softmax", lambda a, k, out: (a[0].dtype, k.get("dtype")))
    spy(F, "conv1d", lambda a, k, out: (site_of(sys._getframe(2))[0], a[1].dtype))
    spy(F, "linear", lambda a, k, out: a[1].dtype)
    spy(model, "_rope_tables", lambda a, k, out: tuple(t.dtype for t in out))
    spy(rvq_ops, "rvq_quantize_reference", lambda a, k, out: a[0].dtype)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    port_encode(params, bf16, ragged(), resample=(3, 2))
    f32, bf = torch.float32, torch.bfloat16
    by = {}
    for name, rec in seen:
        by.setdefault(name, set()).add(rec)
    assert by["layer_norm"] == {f32}
    assert by["softmax"] == {(bf, f32)}
    assert by["linear"] == {bf}
    assert by["_rope_tables"] == {(f32, f32)}
    assert by["rvq_quantize_reference"] == {f32}
    assert by["conv1d"] == {("_resample_batch", f32), ("split_rvq_encode", f32),
                            ("seanet_encode", bf), ("_encode", bf)}


# Launch sites and the mode the JAX package runs each in under
# matmul_precision="high": the nearest enclosing function of a conv or
# matmul launch names its site.
IEEE_SITES = ("_resample_batch", "resblock_elu_reference", "seanet_stage", "split_rvq_encode",
              "rvq_quantize_reference")
TF32_SITES = ("seanet_encode", "transformer_apply", "_encode", "_stream_step",
              "_transformer_step")


def site_of(frame):
    while frame is not None:
        name = frame.f_code.co_name
        if name in IEEE_SITES:
            return name, "ieee"
        if name in TF32_SITES:
            return name, "tf32"
        frame = frame.f_back
    return None, None


class LaunchSpy:
    """Both TF32 flags, the thread and the site at every F.conv1d,
    F.linear, torch.matmul and RVQ call."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((F, "conv1d"), (F, "linear"), (torch, "matmul"),
                          (rvq_ops, "rvq_quantize_reference")):
            monkeypatch.setattr(mod, name, self.wrap(getattr(mod, name)))

    def wrap(self, real):
        def spy(*a, **k):
            site, mode = site_of(sys._getframe(1))
            self.calls.append((threading.current_thread().name, site, mode,
                               torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32))
            return real(*a, **k)

        return spy

    def check(self, thread_modes):
        """Every call in a thread of ``thread_modes`` (thread -> "ieee" for
        a parity engine, "tf32" for a TF32 one) saw the flags of its site's
        mode. Returns the calls per (thread, site)."""
        per = {}
        for thread, site, mode, cudnn, matmul in self.calls:
            if thread not in thread_modes:
                continue
            assert site is not None, "a launch outside every known site"
            want = mode == "tf32" and thread_modes[thread] == "tf32"
            assert cudnn == matmul == want, (thread, site, cudnn, matmul)
            per[(thread, site)] = per.get((thread, site), 0) + 1
        return per


def test_parity_and_tf32_engines_in_two_threads(oracle, monkeypatch):
    """A parity engine and a TF32 engine encode at once in two threads: the
    parity codes equal a parity-only run, and each thread's flags at each
    launch site are its mode's (resample, in_proj, RVQ and the fused
    stage's down-conv IEEE in both; the TF32 engine's other convs and its
    transformer TF32)."""
    _, _, params, cfg = oracle
    rng = np.random.default_rng(3)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32)
              for n in (5000, 19_200, 7777, 30_000)]
    audios16 = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (9000, 14_000)]
    ecfg = EngineConfig(batch_size=2, min_bucket_seconds=0.5, max_chunk_seconds=4.0)
    parity = MimiEncoderEngine(params, cfg, ecfg, num_codebooks=K, device="cpu")
    want = parity.encode_batch(audios) + parity.encode_batch(audios16, sr=16_000)
    tf32 = MimiEncoderEngine(params, dataclasses.replace(cfg, matmul_precision="high"), ecfg,
                             num_codebooks=K, device="cpu")
    before = flags()
    spy = LaunchSpy(monkeypatch)
    out, errors = {}, []

    def run(name, engine):
        try:
            got = []
            for _ in range(2):
                got = engine.encode_batch(audios) + engine.encode_batch(audios16, sr=16_000)
            out[name] = got
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n, e), name=n)
               for n, e in (("parity", parity), ("tf32", tf32))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    for g, w in zip(out["parity"], want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(out["tf32"], want):  # TF32 flags change nothing on the CPU
        np.testing.assert_array_equal(g, w)
    per = spy.check({"parity": "ieee", "tf32": "tf32"})
    for thread in ("parity", "tf32"):
        for site in ("_resample_batch", "seanet_stage", "resblock_elu_reference",
                     "split_rvq_encode", "seanet_encode", "transformer_apply", "_encode"):
            assert per.get((thread, site), 0) > 0, (thread, site)
    assert flags() == before


def test_stream_honours_precision_and_ignores_bf16(oracle, monkeypatch):
    """A TF32 engine's stream steps run TF32 at their convs and transformer
    and IEEE at the RVQ; a bf16 engine streams in float32 (the uncast
    params), with the f32 engine's stream codes."""
    _, _, params, cfg = oracle
    ecfg = EngineConfig(batch_size=2, min_bucket_seconds=0.5, max_chunk_seconds=2.0,
                        long_audio_policy="stream")
    audio = [(np.random.default_rng(4).standard_normal(int(24_000 * 2.6)) * 0.3)
             .astype(np.float32)]
    want = MimiEncoderEngine(params, cfg, ecfg, num_codebooks=K, device="cpu").encode_batch(audio)
    bf16 = MimiEncoderEngine(params, dataclasses.replace(cfg, compute_dtype="bfloat16"), ecfg,
                             num_codebooks=K, device="cpu")
    assert bf16.params["tfm"][0]["q"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.encode_batch(audio)[0], want[0])
    assert bf16.stats.stage_seconds["stream"] > 0
    tf32 = MimiEncoderEngine(params, dataclasses.replace(cfg, matmul_precision="high"), ecfg,
                             num_codebooks=K, device="cpu")
    spy = LaunchSpy(monkeypatch)
    np.testing.assert_array_equal(tf32.encode_batch(audio)[0], want[0])
    per = spy.check({threading.current_thread().name: "tf32"})
    sites = {site for _, site in per}
    assert {"_stream_step", "_transformer_step", "split_rvq_encode"} <= sites, sites


def flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_fp32_precision_nests_and_refuses_tf32_inside_ieee(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with fp32_precision("tf32"):
        assert flags() == (True, True)
        with ieee_fp32():
            assert flags() == (False, False)
            with fp32_precision("tf32"):
                assert flags() == (True, True)
            assert flags() == (False, False)
        assert flags() == (True, True)
    assert flags() == (False, True)
    with ieee_fp32():
        with pytest.raises(RuntimeError, match="TF32 region cannot open"):
            with fp32_precision("tf32"):
                pass
        assert flags() == (False, False)
    assert flags() == (False, True)


def test_tf32_region_waits_for_ieee_holders(monkeypatch):
    """A thread opening a TF32 region waits until an IEEE holder in another
    thread leaves, and a thread opening an IEEE region waits until the TF32
    holder leaves; each sees its own mode's flags throughout."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    order, seen = [], []
    ieee_in, tf32_waiting = threading.Event(), threading.Event()

    def first_ieee():
        with ieee_fp32():
            ieee_in.set()
            tf32_waiting.wait(10)
            for _ in range(50):  # the TF32 thread must not get in meanwhile
                seen.append(("ieee", flags()))
            order.append("ieee out")

    def then_tf32():
        ieee_in.wait(10)
        tf32_waiting.set()
        with fp32_precision("tf32"):
            order.append("tf32 in")
            seen.append(("tf32", flags()))

    threads = [threading.Thread(target=f) for f in (first_ieee, then_tf32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert order == ["ieee out", "tf32 in"]
    assert all(f == ((True, True) if m == "tf32" else (False, False)) for m, f in seen)
    assert flags() == (True, True)


def test_fp32_precision_stress_mixed_modes(monkeypatch):
    """More threads than cores enter IEEE and TF32 regions (with an IEEE
    region nested in each TF32 one) at random: every region sees its own
    mode's flags, and the flags are restored at the end."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bad = []

    def work(i):
        for j in range(150):
            if (i + j) % 3 == 0:
                with fp32_precision("tf32"):
                    if flags() != (True, True):
                        bad.append(("tf32", flags()))
                    with ieee_fp32():
                        if flags() != (False, False):
                            bad.append(("nested ieee", flags()))
                    if flags() != (True, True):
                        bad.append(("tf32 after", flags()))
            else:
                with ieee_fp32():
                    if flags() != (False, False):
                        bad.append(("ieee", flags()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert flags() == (False, False)
