"""PyTorch port, qualification kit: the port's kit (``device="cpu"``) against
the JAX package's on the tiny HF oracle and the same audio — the same
conversion counts, frames, flips, per-seed table and verdict, per-layer
deviations within 1e-5 of JAX's, the corrupted-codebook gate failing both,
the CLI, the ``--hf-dir`` file-conversion check, and the flip forensics with
each utterance's latent computed once."""

import copy
import json
import types

import jax
import numpy as np
import pytest

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu import qualify as jax_qualify
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu_torch import qualify
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.mimi import config_from_hf, params_from_torch_model

ENGINE_KW = dict(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=4.0)
SWEEP = dict(audio_seeds=(0, 1), n_utts=4, max_seconds=2.0)
SAME = ("frames", "flipped_frames", "flips", "per_seed", "non_tie_flips", "audio_seconds")


@pytest.fixture(scope="module")
def tiny_oracle():
    return make_oracle(tiny_hf_config())


def kits(model, params=None, cfg=None, bf16=True, **sweep):
    """The JAX kit's report and the port's, on the same model and audio."""
    kw = dict(SWEEP, **sweep)
    jax_rep = jax_qualify.run_qualification(
        model=model, params=params, cfg=cfg, engine_cfg=JaxEngineConfig(**ENGINE_KW),
        bf16=bf16, **kw)
    port_rep = qualify.run_qualification(
        model=model, params=params, engine_cfg=EngineConfig(**ENGINE_KW), bf16=bf16,
        device="cpu", **kw)
    return jax_rep, port_rep


@pytest.fixture(scope="module")
def passing(tiny_oracle):
    return kits(tiny_oracle[0])


def test_report_equals_jax_kit(passing):
    jax_rep, rep = passing
    assert rep["passed"] is True and jax_rep["passed"] is True
    assert rep["checks"]["conversion"] == jax_rep["checks"]["conversion"]
    for key in SAME:
        assert rep["checks"]["exact_codes"][key] == jax_rep["checks"]["exact_codes"][key], key
    assert rep["checks"]["exact_codes"]["frames"] > 0
    assert rep["value"] == jax_rep["value"] == rep["checks"]["exact_codes"]["frame_exact"]
    assert rep["device"] == "cpu" and rep["transformers"]
    e = rep["checks"]["exact_codes"]
    assert rep["hf_sliding_window"] is qualify._hf_encode_windowed()
    assert e["flips_past_window"] == sum(
        f["frame"] >= e["window_frame"] for f in jax_rep["checks"]["exact_codes"]["flips"])
    assert 0 <= e["frames_past_window"] < e["frames"]
    assert 0 <= rep["checks"]["bf16_fast_mode"]["code_match_vs_f32"] <= 1
    json.dumps(rep)  # the report serializes as-is
    md = qualify.to_markdown(rep)
    assert "PASS" in md and "exact_codes" in md and "transformers" in md


def test_per_layer_deviations_match_jax_kit(passing):
    jax_rep, rep = passing
    got, want = rep["checks"]["per_layer"], jax_rep["checks"]["per_layer"]
    assert got["ok"] and got["seanet_max_abs_dev"] < qualify.SEANET_ATOL
    assert got["transformer_max_abs_dev"] < qualify.TFM_ATOL
    for key in ("seanet_max_abs_dev", "transformer_max_abs_dev"):
        assert abs(got[key] - want[key]) <= 1e-5, key


def test_conversion_equals_jax_leaf_for_leaf(tiny_oracle):
    """The port's HF -> params conversion and its leaf walk equal the JAX
    package's conversion under jax.tree_util, leaf for leaf."""
    model, jax_params, _ = tiny_oracle
    port = dict(qualify._leaves_with_path(params_from_torch_model(model)))
    want = {
        tuple(k.key if hasattr(k, "key") else k.idx for k in kp): v
        for kp, v in jax.tree_util.tree_leaves_with_path(jax_params)
    }
    assert port.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(np.asarray(port[key]), np.asarray(v))


def test_corrupted_codebook_fails_both_kits(tiny_oracle):
    """Corrupt the semantic codebook: both kits record NON-tie flips and
    fail (a real parity break cannot pass as ties)."""
    model, params, cfg = tiny_oracle
    bad = copy.deepcopy(params)
    bad["rvq"]["semantic"]["embed"] = np.asarray(bad["rvq"]["semantic"]["embed"]) * 1.5 + 0.05
    jax_rep, rep = kits(model, params=bad, cfg=cfg, bf16=False, audio_seeds=(0,))
    for r, kit in ((jax_rep, jax_qualify), (rep, qualify)):
        assert r["passed"] is False and r["checks"]["exact_codes"]["non_tie_flips"] > 0
        assert "FAIL" in kit.to_markdown(r)
    for key in SAME:
        assert rep["checks"]["exact_codes"][key] == jax_rep["checks"]["exact_codes"][key], key


def test_cli_oracle_seed_writes_reports(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(
        qualify, "_random_oracle", lambda seed: make_oracle(tiny_hf_config(), seed=seed)[0]
    )
    out, out_md = tmp_path / "rep.json", tmp_path / "rep.md"
    rc = qualify.main([
        "--oracle-seed", "0", "--audio-seeds", "0", "--utterances", "3",
        "--max-seconds", "2", "--no-bf16", "--device", "cpu",
        "--out", str(out), "--out-md", str(out_md),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["metric"] == "qualification_frame_exact" and summary["passed"] is True
    full = json.loads(out.read_text())
    assert full["source"] == "oracle_seed:0" and "exact_codes" in full["checks"]
    assert "qualification" in out_md.read_text()


def test_hf_dir_file_conversion_matches_module(tiny_oracle, tmp_path):
    tiny_oracle[0].save_pretrained(str(tmp_path / "ckpt"))
    out = tmp_path / "rep.json"
    rc = qualify.main([
        "--hf-dir", str(tmp_path / "ckpt"), "--audio-seeds", "0", "--utterances", "3",
        "--max-seconds", "2", "--no-bf16", "--device", "cpu", "--out", str(out),
    ])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["source"] == f"hf_dir:{tmp_path / 'ckpt'}"
    assert rep["checks"]["file_conversion_matches_module"] == {"max_abs_dev": 0.0, "ok": True}
    assert rep["checks"]["conversion"]["tensors"] > 0


def test_flip_margin_latent_reused_equals_per_flip_walk(tiny_oracle):
    """Margins from one latent per utterance equal the per-flip walk's (the
    port's without a latent, and the JAX kit's) at every book."""
    model = tiny_oracle[0]
    audio = max(qualify._qual_audio(0, 4, 2.0), key=len)
    ref = qualify._hf_codes(model, audio, 12)
    latent = qualify._hf_latent(model, audio)
    assert ref.shape[1] >= 8
    for frame, book in ((0, 0), (3, 1), (5, 7), (ref.shape[1] - 1, 11)):
        a, b = int(ref[book, frame]), int(ref[book, frame] + 1) % 64
        cached = qualify._flip_margin(model, audio, frame, book, a, b, latent)
        assert cached == qualify._flip_margin(model, audio, frame, book, a, b)
        assert cached == jax_qualify._flip_margin(model, audio, frame, book, a, b)
        assert cached > 0


def test_config_from_hf_is_full_causal_on_transformers_4_and_5(monkeypatch):
    """transformers 5.x keeps rope_theta in rope_parameters and masks the
    encode's transformer with its sliding window; 4.x does neither.
    config_from_hf reads either layout and stays full causal, as the JAX
    package's and every processor's config; the kit reports the installed
    version's window mode and the first frame past the window."""
    from tokenize_audio_tpu.mimi.weights import config_from_hf as jax_config_from_hf
    from transformers.models.mimi import modeling_mimi

    from tokenize_audio_tpu_torch.mimi.config import MimiConfig

    hf = tiny_hf_config()
    installed = hasattr(modeling_mimi, "create_sliding_window_causal_mask")
    cfg = config_from_hf(hf)
    assert cfg.rope_theta == hf.rope_theta and cfg.use_sliding_window is False
    assert cfg.use_sliding_window == jax_config_from_hf(hf).use_sliding_window
    v5 = types.SimpleNamespace(**{k: v for k, v in hf.to_dict().items() if k != "rope_theta"},
                               rope_parameters={"rope_type": "default", "rope_theta": 5000.0})
    assert config_from_hf(v5).rope_theta == 5000.0
    assert config_from_hf(v5).use_sliding_window is False
    assert qualify._hf_encode_windowed() is installed
    monkeypatch.setattr(modeling_mimi, "create_sliding_window_causal_mask", object(),
                        raising=False)
    assert qualify._hf_encode_windowed() is True
    assert config_from_hf(hf).use_sliding_window is False
    monkeypatch.delattr(modeling_mimi, "create_sliding_window_causal_mask")
    assert qualify._hf_encode_windowed() is False
    # 250 steps at 25 Hz: code frame 125 (10 s) is the first past the window
    assert qualify._window_frame(MimiConfig()) == 125
