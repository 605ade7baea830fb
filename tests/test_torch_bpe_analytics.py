"""PyTorch port, codec BPE and analytics: the sampler, trainer, tokenizer
surgery, row counting, token estimation and validation against the JAX
package's (the cases of tests/test_bpe_analytics.py, test_surgery.py and
test_validate.py under the same names, plus each command line). Each case
runs through both packages on the same seeded inputs: the .npy corpora
(array_equal, dtype included), tokenizers (parsed vocab, merges and added
tokens), resized embeddings (bit-equal on the CPU), reports, estimates and
validation reports must be exactly equal; the JAX tests' own outcomes are
held on the port's run."""

import json
import os

import numpy as np
import pytest
import torch

from torch_downstream import (
    PORT,
    WSTok,
    assert_npy_equal,
    both,
    make_npy,
    norm,
    npy_tree,
    tokenizer_dir,
    tokenizer_of,
)

K, S, OFF = 4, 16, 0xE000  # small codec for fast training


# ---- codec BPE (tests/test_bpe_analytics.py) ----


def test_load_codes_file_formats(tmp_path):
    def scenario(m, root, rng):
        p, arrays = make_npy(m, root / "codes_0.npy", rng, K, S, n_utts=3)
        single = rng.integers(0, S, size=(1, K, 10))
        np.save(str(root / "single.npy"), single)
        return arrays, m.trainer.load_codes_file(p), m.trainer.load_codes_file(
            str(root / "single.npy"))

    port, ref = both(tmp_path, scenario)
    for got, want in zip(port[1:], ref[1:]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    arrays, loaded, (got,) = port
    assert len(loaded) == 3 and np.array_equal(loaded[0], arrays[0])
    assert got.shape == (K, 10)


def test_trainer_no_merge_alphabet_only(tmp_path):
    def scenario(m, root, rng):
        make_npy(m, root / "codes_0.npy", rng, K, S)
        tok = m.trainer.CodecBPETrainer(
            K, S, vocab_size=K * S + 2, eos_token="<eos>", unk_token="<unk>",
            max_token_codebook_ngrams=0, unicode_offset=OFF,
        ).train(str(root))
        codes = rng.integers(0, S, size=(K, 5), dtype=np.int64)
        s = m.codes.codes_to_chars(codes, S, unicode_offset=OFF)
        return tokenizer_of(tok), len(tok), tok.encode(s)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    assert port[1] == K * S + 2 and len(port[2]) == K * 5


def test_trainer_with_merges_and_ngram_cap(tmp_path):
    def scenario(m, root, rng):
        make_npy(m, root / "codes_0.npy", rng, K, S)
        tok = m.trainer.CodecBPETrainer(
            K, S, codec_framerate=12.5, chunk_size_secs=2, vocab_size=K * S + 64,
            min_frequency=2, eos_token="<eos>", unk_token="<unk>",
            max_token_codebook_ngrams=2, unicode_offset=OFF,
        ).train(str(root))
        codes = rng.integers(0, S, size=(K, 8), dtype=np.int64)
        s = m.codes.codes_to_chars(codes, S, unicode_offset=OFF)
        return tokenizer_of(tok), len(tok), s, tok.encode(s), tok.decode(tok.encode(s))

    port, ref = both(tmp_path, scenario)
    assert port == ref
    parts, n, s, _, decoded = port
    assert n > K * S + 2 and parts["merges"]
    assert max(len(t) for t in parts["vocab"] if not t.startswith("<")) <= 2 * K
    assert decoded == s


def test_trainer_vocab_too_small(tmp_path):
    def scenario(m, root, rng):
        with pytest.raises(ValueError, match="minimum") as info:
            m.trainer.CodecBPETrainer(K, S, vocab_size=10, eos_token="<eos>")
        return str(info.value)

    port, ref = both(tmp_path, scenario)
    assert port == ref


def test_extend_tokenizer(tmp_path):
    def scenario(m, root, rng):
        make_npy(m, root / "codes_0.npy", rng, K, S)
        base = m.trainer.CodecBPETrainer(
            2, 4, vocab_size=2 * 4 + 1, eos_token="<eos>", max_token_codebook_ngrams=0,
            unicode_offset=0xF000,
        ).train(str(root))
        before = len(base)
        out = m.trainer.extend_tokenizer(
            base, num_codebooks=K, codebook_size=S, unicode_offset=OFF,
            special_tokens=["<|audio_start|>", "<|audio_end|>"],
        )
        return before, len(out), tokenizer_of(out), out.encode(chr(OFF) + "<|audio_start|>")

    port, ref = both(tmp_path, scenario)
    assert port == ref
    before, after, _, ids = port
    assert after == before + K * S + 2 and len(ids) == 2


def _sampler_hub(m, root, rng):
    hub = m.hub.LocalHub(str(root / "hub"))
    for shard in ("en000", "en001"):
        for i in range(4):
            entries = [{"audio_id": f"{shard}-a{i}",
                        "codes": {"c0": rng.integers(0, S, size=(32, 6)).tolist(), "c1": []}}]
            p = root / "tmp.json"
            p.write_text(json.dumps(entries))
            hub.upload_file(str(p), f"data/{shard}/{i:08d}.json")
    return hub


def test_sampler(tmp_path):
    def scenario(m, root, rng):
        hub = _sampler_hub(m, root, rng)
        shard_subs = {s: [f"{i:08d}" for i in range(4)] for s in ("en000", "en001")}
        picks = m.sampler.pick_subshards(shard_subs, per_shard=2, seed=7)
        out_dir = str(root / "npys")
        sampler = m.sampler.CodeSampler(hub, out_dir, num_codebooks=8)
        rep = sampler.sample(picks)
        progress = (root / "npys" / "sampling_progress.txt").read_text()
        return (picks, picks == m.sampler.pick_subshards(shard_subs, per_shard=2, seed=7), rep,
                npy_tree(out_dir), progress, sampler.sample(picks))

    port, ref = both(tmp_path, scenario)
    assert_npy_equal(port[3], ref[3])
    assert port[:3] + port[4:] == ref[:3] + ref[4:]
    picks, same, rep, tree, progress, rep2 = port
    assert len(picks) == 4 and same and rep["processed"] == 4
    (dtype, first), = tree[f"{picks[0][0]}_{picks[0][1]}.npy"]
    assert first.shape == (8, 6) and dtype == "<u2"
    assert progress.splitlines() == [f"{s}/{i}" for s, i in picks]
    assert rep2 == {"processed": 0, "skipped": 4, "failed": 0}


def test_codes_from_entries_slices(tmp_path):
    entries = [{"codes": {"a": [[1, 2], [3, 4], [5, 6]]}}]
    port, ref = both(tmp_path, lambda m, root, rng: m.sampler.codes_from_entries(
        entries, num_codebooks=2))
    assert len(port) == len(ref) == 1
    assert port[0].dtype == ref[0].dtype == np.uint16 and np.array_equal(port[0], ref[0])
    assert port[0].shape == (2, 2)


# ---- analytics (tests/test_bpe_analytics.py) ----


def _group_hub(m, root):
    hub = m.hub.LocalHub(str(root / "hub"))
    for grp, n in (("en", 3), ("de", 2)):
        rows = [{"id": f"{grp}{i}", "text": "ab " * (i + 1)} for i in range(n)]
        hub.upload_file(m.parquet.write_parquet(rows, str(root / f"{grp}.parquet")),
                        f"{grp}/part0.parquet")
    return hub


def test_analytics_count_and_estimate(tmp_path):
    def scenario(m, root, rng):
        hub = _group_hub(m, root)
        groups = m.count_rows.count_hub_dataset(hub, group_depth=1)
        est = m.estimate_tokens.TokenEstimator(WSTok())
        result = est.estimate_hub_dataset(hub, group_depth=1, sample_rows=100)
        strat = est.stratified_estimate({"en": ["a b", "c"]}, {"en": 10})
        sentinel, seen = {"estimated_total_tokens": -1}, []
        result2 = est.estimate_hub_dataset(hub, group_depth=1, sample_rows=100,
                                           resume={"en": sentinel},
                                           on_group=lambda k, s: seen.append(k))
        return (groups, m.count_rows.stats_markdown(groups), result, strat, result2, seen,
                result2["en"] is sentinel)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    groups, md, result, strat, result2, seen, kept = port
    assert groups["en"]["rows"] == 3 and groups["de"]["rows"] == 2
    assert "| **total** | 2 | 5 |" in md
    assert result["en"]["total_rows"] == 3 and result["en"]["estimated_total_tokens"] == 6
    assert strat["en"]["estimated_total_tokens"] == 15
    assert strat["_total"]["estimated_total_tokens"] == 15
    assert kept and seen == ["de"] and result2["de"] == result["de"]


def test_range_reader_footer_only_counting(tmp_path):
    import pyarrow.parquet as pq

    def scenario(m, root, rng):
        hub = m.hub.LocalHub(str(root / "hub"))
        rows = [{"id": f"r{i}", "text": rng.bytes(2000).hex()} for i in range(500)]
        hub.upload_file(m.parquet.write_parquet(rows, str(root / "big.parquet")),
                        "data/big.parquet")
        rd = m.count_rows.RangeReader(hub, "data/big.parquet")
        n = pq.ParquetFile(rd).metadata.num_rows
        rd2 = m.count_rows.RangeReader(hub, "data/big.parquet")
        rd2.seek(-4, 2)
        tail = rd2.read()
        rd2.seek(0)
        return (n, rd.bytes_read, hub.size("data/big.parquet"),
                m.count_rows.count_parquet_rows_remote(hub, "data/big.parquet"),
                m.count_rows.count_parquet_rows(str(root / "big.parquet")), tail, rd2.read(4))

    port, ref = both(tmp_path, scenario)
    # the two files hold the same rows; their byte sizes may differ with the
    # writer, so the transfer is held to the JAX test's bounds
    assert port[0] == ref[0] and port[3:] == ref[3:]
    n, read, total, remote, local, tail, head = port
    assert total > 100_000 and n == remote == local == 500
    assert read < 0.1 * total, (read, total)
    assert tail == head == b"PAR1"


def test_estimate_tokens_partial_transfer(tmp_path, monkeypatch):
    def scenario(m, root, rng):
        hub = m.hub.LocalHub(str(root / "hub"))
        rows = [{"id": f"r{i}", "text": "tok tok tok", "payload": rng.bytes(4000).hex()}
                for i in range(300)]
        hub.upload_file(m.parquet.write_parquet(rows, str(root / "f.parquet")), "all/f.parquet")
        transferred = []

        class CountingReader(m.count_rows.RangeReader):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                transferred.append(self)

        with monkeypatch.context() as mp:
            mp.setattr(m.estimate_tokens, "RangeReader", CountingReader)
            res = m.estimate_tokens.TokenEstimator(WSTok()).estimate_hub_dataset(
                hub, sample_rows=20)
        return res, sum(r.bytes_read for r in transferred), hub.size("all/f.parquet")

    port, ref = both(tmp_path, scenario)
    assert port[0] == ref[0]
    res, read, total = port
    assert res["all"]["total_rows"] == 300 and res["all"]["mean_tokens_per_row"] == 3.0
    assert res["all"]["estimated_total_tokens"] == 900
    assert read < 0.5 * total, (read, total)


def test_estimate_with_rows_distribution(tmp_path):
    def scenario(m, root, rng):
        hub = m.hub.LocalHub(str(root / "hub"))
        rows = [{"id": f"r{i}", "text": "a b"} for i in range(5)]
        hub.upload_file(m.parquet.write_parquet(rows, str(root / "f.parquet")), "en/f.parquet")
        return m.estimate_tokens.TokenEstimator(WSTok()).estimate_hub_dataset(
            hub, group_depth=1, rows_distribution={"en": {"files": 99, "rows": 1000}})

    port, ref = both(tmp_path, scenario)
    assert port == ref
    assert port["en"]["total_rows"] == 1000 and port["en"]["estimated_total_tokens"] == 2000


def test_stats_markdown_with_tokens(tmp_path):
    groups = {"en": {"files": 2, "rows": 100}, "de": {"files": 1, "rows": 50}}
    tokens = {"en": {"estimated_total_tokens": 1234},
              "_total": {"estimated_total_tokens": 1234}}
    port, ref = both(tmp_path, lambda m, root, rng: m.count_rows.stats_markdown(groups, tokens))
    assert port == ref
    assert "| en | 2 | 100 | 1,234 |" in port and "| de | 1 | 50 | XXX |" in port
    assert "| **total** | 3 | 150 | 1,234 |" in port


# ---- tokenizer surgery (tests/test_surgery.py) ----


def make_base(m, root, rng):
    arrays = [rng.integers(0, 4, size=(2, 16), dtype=np.uint16) for _ in range(4)]
    obj = np.empty(len(arrays), dtype=object)
    obj[:] = arrays
    np.save(str(root / "c.npy"), obj, allow_pickle=True)
    tok = m.trainer.CodecBPETrainer(
        2, 4, vocab_size=2 * 4 + 2, eos_token="<|endoftext|>", unk_token="<unk>",
        max_token_codebook_ngrams=0, unicode_offset=0xF000,
    ).train(str(root))
    d = str(root / "base")
    tok.save_pretrained(d)
    return d, tok


def _tiny_lm(tie: bool, vocab_size: int = 32):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=vocab_size, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                      tie_word_embeddings=tie)
    return LlamaForCausalLM(cfg)


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_weights_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_rename_preserves_id(tmp_path):
    from transformers import AutoTokenizer

    def scenario(m, root, rng):
        base_dir, base = make_base(m, root, rng)
        old_id = base.convert_tokens_to_ids("<|endoftext|>")
        out_dir = str(root / "renamed")
        m.surgery.rename_token_in_place(base_dir, "<|endoftext|>", "<|end_of_text|>", out_dir)
        tok2 = AutoTokenizer.from_pretrained(out_dir)
        return (tokenizer_dir(out_dir), old_id, tok2.convert_tokens_to_ids("<|end_of_text|>"),
                "<|endoftext|>" in tok2.get_vocab())

    port, ref = both(tmp_path, scenario)
    assert port == ref
    _, old_id, new_id, still = port
    assert new_id == old_id and not still


def test_extend_model_embeddings_untied(tmp_path):
    def scenario(m, root, rng):
        model = _tiny_lm(tie=False)
        orig = _weights(model)
        m.surgery.extend_model_embeddings(model, 48, num_tokens_to_copy=30, noise_std=0.01)
        with torch.no_grad():
            logits = model(torch.tensor([[47, 2, 33]])).logits
        return orig, _weights(model), model.config.vocab_size, logits

    port, ref = both(tmp_path, scenario)
    assert_weights_equal(port[0], ref[0])
    assert_weights_equal(port[1], ref[1])  # bit-equal: same seed, same CPU ops
    assert port[2] == ref[2] == 48 and torch.equal(port[3], ref[3])
    orig, new, _, logits = port
    w, h = new["model.embed_tokens.weight"], new["lm_head.weight"]
    assert w.shape == (48, 16) and h.shape == (48, 16)
    assert torch.equal(w[:30], orig["model.embed_tokens.weight"][:30])
    assert torch.equal(h[:30], orig["lm_head.weight"][:30])
    mean = orig["model.embed_tokens.weight"][:30].float().mean(0)
    assert (w[30:] - mean).abs().max() < 0.1 and not torch.equal(w[30], w[31])
    assert logits.shape == (1, 3, 48)


def test_extend_model_embeddings_tied(tmp_path):
    def scenario(m, root, rng):
        model = _tiny_lm(tie=True)
        m.surgery.extend_model_embeddings(model, 40)
        w, h = model.get_input_embeddings().weight, model.get_output_embeddings().weight
        with torch.no_grad():
            logits = model(torch.tensor([[39, 0]])).logits
        return w.detach().clone(), h.data_ptr() == w.data_ptr(), logits

    port, ref = both(tmp_path, scenario)
    assert torch.equal(port[0], ref[0]) and torch.equal(port[2], ref[2]) and port[1] == ref[1]
    assert port[0].shape == (40, 16) and port[1] and port[2].shape == (1, 2, 40)


def test_extend_model_embeddings_rejects_shrink(tmp_path):
    def scenario(m, root, rng):
        model = _tiny_lm(tie=False)
        errors = []
        for args, kw in (((16,), {}), ((64,), {"num_tokens_to_copy": 33})):
            with pytest.raises(ValueError) as info:
                m.surgery.extend_model_embeddings(model, *args, **kw)
            errors.append(str(info.value))
        return errors

    port, ref = both(tmp_path, scenario)
    assert port == ref


def test_set_bos(tmp_path):
    def scenario(m, root, rng):
        base_dir, base = make_base(m, root, rng)
        tok = m.surgery.set_bos_token(base_dir, "<|begin_of_text|>")
        return len(base), len(tok), tok.bos_token, tokenizer_of(tok)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    n, n2, bos, _ = port
    assert bos == "<|begin_of_text|>" and n2 == n + 1


def _model_dir(path):
    """A saved model: its config (version stamp aside) and its tensors."""
    from safetensors.torch import load_file

    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg.pop("transformers_version", None)
    return cfg, load_file(os.path.join(path, "model.safetensors"))


def _surgery_cli(m, root, argv, capsys):
    capsys.readouterr()
    m.surgery.main(argv + (["--device", "cpu"] if m.name == "port" else []))
    return norm(json.loads(capsys.readouterr().out), root)


def test_cli_end_to_end(tmp_path, capsys):
    from transformers import AutoModelForCausalLM, AutoTokenizer

    def scenario(m, root, rng):
        base_dir, base = make_base(m, root, rng)
        old_id = base.convert_tokens_to_ids("<|endoftext|>")
        model_dir = str(root / "lm")
        _tiny_lm(tie=False, vocab_size=16).save_pretrained(model_dir)
        out_dir, model_out = str(root / "qx"), str(root / "lmx")
        report = _surgery_cli(m, root, [
            "--tokenizer", base_dir, "--out-dir", out_dir,
            "--rename", "<|endoftext|>=<|end_of_text|>", "--bos", "<|begin_of_text|>",
            "--add-audio-alphabet", "--num-codebooks", "2", "--codebook-size", "4",
            "--unicode-offset", "0xE000", "--pipeline-specials",
            "--model", model_dir, "--model-out", model_out,
        ], capsys)
        return report, old_id, tokenizer_dir(out_dir), _model_dir(model_out), out_dir, model_out

    port, ref = both(tmp_path, scenario)
    assert port[:3] == ref[:3] and port[3][0] == ref[3][0]
    assert_weights_equal(port[3][1], ref[3][1])
    report, old_id, _, _, out_dir, model_out = port
    assert report == {"tokenizer_out": "<dir>/qx", "vocab_size": report["vocab_size"],
                      "model_out": "<dir>/lmx", "model_vocab_size": report["vocab_size"]}
    tok = AutoTokenizer.from_pretrained(out_dir)
    assert tok.convert_tokens_to_ids("<|end_of_text|>") == old_id
    assert tok.bos_token == "<|begin_of_text|>"
    for ch in (chr(0xE000), chr(0xE000 + 2 * 4 - 1), "<|audio_start|>"):
        assert ch in tok.get_vocab()
    lm = AutoModelForCausalLM.from_pretrained(model_out)
    assert lm.config.vocab_size == len(tok)
    ids = torch.tensor([[len(tok) - 1, tok.convert_tokens_to_ids(chr(0xE000))]])
    with torch.no_grad():
        assert lm(ids).logits.shape[-1] == len(tok)


def test_cli_num_tokens_to_copy(tmp_path, capsys):
    def scenario(m, root, rng):
        base_dir, base = make_base(m, root, rng)
        n_real = len(base)
        model_dir = str(root / "lm_padded")
        lm = _tiny_lm(tie=False, vocab_size=32)
        with torch.no_grad():
            lm.get_input_embeddings().weight[n_real:] = 1e6
        lm.save_pretrained(model_dir)
        report = _surgery_cli(m, root, [
            "--tokenizer", base_dir, "--out-dir", str(root / "qx2"), "--add-audio-alphabet",
            "--num-codebooks", "2", "--codebook-size", "4", "--unicode-offset", "0xE000",
            "--model", model_dir, "--model-out", str(root / "lmx2"),
            "--num-tokens-to-copy", str(n_real),
        ], capsys)
        return report, n_real, lm.get_input_embeddings().weight.detach().clone(), _model_dir(
            str(root / "lmx2"))

    port, ref = both(tmp_path, scenario)
    assert port[:2] == ref[:2] and port[3][0] == ref[3][0]
    assert_weights_equal(port[3][1], ref[3][1])
    _, n_real, orig, (_, tensors) = port
    w = tensors["model.embed_tokens.weight"]
    assert w.shape[0] > n_real and torch.equal(w[:n_real], orig[:n_real])
    assert w[n_real:].abs().max().item() < 100.0


def test_surgery_cuda_without_a_card_raises_first(tmp_path, monkeypatch, capsys):
    """``--device cuda`` (or no ``--device``) where there is no card raises
    through ``resolve_device`` before anything is written; without
    ``--model`` the device is not needed and nothing is asked of it."""
    from tokenize_audio_tpu_torch.bpe import surgery

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base_dir, _ = make_base(PORT, tmp_path, np.random.default_rng(0))
    _tiny_lm(tie=False).save_pretrained(str(tmp_path / "lm"))
    for device in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            surgery.main(["--tokenizer", base_dir, "--out-dir", str(tmp_path / "out"),
                          "--model", str(tmp_path / "lm"), *device])
        assert not (tmp_path / "out").exists()
    surgery.main(["--tokenizer", base_dir, "--out-dir", str(tmp_path / "out")])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["vocab_size"] == 10


# ---- validation (tests/test_validate.py) ----


def make_span(m, rng, frames=4):
    codes = rng.integers(0, 2048, size=(8, frames))
    return m.codes.codes_to_chars(codes, 2048, unicode_offset=OFF)


def test_valid_documents_pass(tmp_path):
    def scenario(m, root, rng):
        span = make_span(m, rng)
        return (m.validate.validate_document(m.base.tts_document("hello", span)),
                m.validate.validate_document(m.base.asr_document("hi", span)))

    port, ref = both(tmp_path, scenario)
    assert port == ref == ([], [])


def test_grammar_violations_detected(tmp_path):
    def scenario(m, root, rng):
        span = make_span(m, rng)
        v = m.validate.validate_document
        nested = ("<|begin_of_text|><|audio_start|><|text_start|>x<|text_end|>"
                  "<|audio_end|><|end_of_text|>")
        unclosed = "<|begin_of_text|><|audio_start|>" + span + "<|end_of_text|>"
        return (v(m.base.tts_document("x", span)[10:]), v(m.base.tts_document("x", span)[:-5]),
                v(nested), v(unclosed))

    port, ref = both(tmp_path, scenario)
    assert port == ref
    no_bos, no_eos, nested, unclosed = port
    assert "missing bos" in no_bos and "missing eos" in no_eos
    assert any("nested" in p for p in nested) and any("unclosed" in p for p in unclosed)


def test_code_invariants_detected(tmp_path):
    def scenario(m, root, rng):
        span = make_span(m, rng)
        shuffled = span[8:16] + span[8:16][::-1]
        return (m.validate.validate_document(m.base.tts_document("x", span[:-3])),
                m.validate.validate_document(m.base.tts_document("x", shuffled)))

    port, ref = both(tmp_path, scenario)
    assert port == ref
    assert any("% 8 != 0" in p for p in port[0]) and any("invalid codes" in p for p in port[1])


def test_all_tag_problems_collected(tmp_path):
    def scenario(m, root, rng):
        span = make_span(m, rng)
        doc = ("<|begin_of_text|><|audio_start|><|text_start|>x<|text_end|><|audio_end|>"
               "<|text_end|><|audio_start|>" + span + "<|end_of_text|>")
        stray = ("<|begin_of_text|><|audio_start|>" + span + "<|text_end|><|audio_end|>"
                 "<|end_of_text|>")
        return m.validate.validate_document(doc), m.validate.validate_document(stray)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    probs, stray = port
    for word in ("nested", "unmatched", "unclosed"):
        assert any(word in p for p in probs)
    tag_probs = [p for p in stray if "matched" in p or "closed" in p or "nested" in p]
    assert len(tag_probs) == 1 and "unmatched text_end" in tag_probs[0]


def test_null_text_row_still_checked_for_duplicate_id(tmp_path):
    def scenario(m, root, rng):
        span = make_span(m, rng)
        return m.validate.validate_rows([{"id": "a", "text": m.base.tts_document("ok", span)},
                                         {"id": "a", "text": None}])

    port, ref = both(tmp_path, scenario)
    assert port == ref
    probs = port["problems"]["a"]
    assert any("duplicate id" in p for p in probs) and any("non-string text" in p for p in probs)


def test_validate_rows_and_cli(tmp_path, capsys):
    def scenario(m, root, rng):
        span = make_span(m, rng)
        rows = [{"id": "a_type1", "text": m.base.tts_document("ok", span)},
                {"id": "a_type1", "text": m.base.tts_document("dup id", span)},
                {"id": "b", "text": "<|begin_of_text|>no eos"}]
        rep = m.validate.validate_rows(rows)
        hub = m.hub.LocalHub(str(root / "hub"))
        hub.upload_file(m.parquet.write_parquet(rows[:1], str(root / "good.parquet")),
                        "data/good.parquet")
        argv = ["--hub", f"dir:{root}/hub", "--prefix", "data/"]
        capsys.readouterr()
        rc_good = m.validate.main(argv)
        out_good = json.loads(capsys.readouterr().out)
        hub.upload_file(m.parquet.write_parquet(rows, str(root / "bad.parquet")),
                        "data/bad.parquet")
        rc_bad = m.validate.main(argv + ["--sample-rows", "2", "--seed", "3"])
        return rep, rc_good, out_good, rc_bad, json.loads(capsys.readouterr().out)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    rep, rc_good, out_good, rc_bad, out_bad = port
    assert rep["rows"] == 3 and rep["bad_rows"] == 2
    assert rc_good == 0 and out_good["data/good.parquet"]["bad_rows"] == 0
    assert rc_bad == 1 and out_bad["data/bad.parquet"]["rows"] == 2


# ---- the command lines ----


def test_sampler_cli(tmp_path, capsys):
    """``bpe.sampler.main`` enumerates the hub's sub-shards, samples 2 per
    shard and resumes: printed reports, .npy corpus and progress file equal
    the JAX CLI's."""
    def scenario(m, root, rng):
        _sampler_hub(m, root, rng)
        argv = ["--hub", f"dir:{root / 'hub'}", "--out-dir", str(root / "npys"),
                "--per-shard", "2", "--seed", "7", "--num-codebooks", "4"]
        capsys.readouterr()
        m.sampler.main(argv)
        m.sampler.main(argv)
        reports = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        return reports, (root / "npys" / "sampling_progress.txt").read_text(), npy_tree(
            str(root / "npys"))

    port, ref = both(tmp_path, scenario)
    assert port[:2] == ref[:2]
    assert_npy_equal(port[2], ref[2])
    assert port[0] == [{"processed": 4, "skipped": 0, "failed": 0},
                       {"processed": 0, "skipped": 4, "failed": 0}]
    assert all(a.shape == (4, 6) for items in port[2].values() for _, a in items)


def test_trainer_cli_and_extend_base(tmp_path, capsys):
    """``bpe.trainer.main`` trains (chunked streams, a 2-frame n-gram cap,
    the pipeline specials), then extends the result as ``--extend-base``:
    printed reports and saved tokenizers equal the JAX CLI's."""
    def scenario(m, root, rng):
        (root / "npys").mkdir()
        make_npy(m, root / "npys" / "codes_0.npy", rng, K, S)
        capsys.readouterr()
        m.trainer.main(["--codes-dir", str(root / "npys"), "--out-dir", str(root / "tok"),
                        "--num-codebooks", str(K), "--codebook-size", str(S),
                        "--vocab-size", str(K * S + 48), "--max-token-codebook-ngrams", "2",
                        "--chunk-size-secs", "2", "--unicode-offset", "0xE000",
                        "--pipeline-specials", "--num-files", "1"])
        m.trainer.main(["--extend-base", str(root / "tok"), "--out-dir", str(root / "ext"),
                        "--num-codebooks", "2", "--codebook-size", "4",
                        "--unicode-offset", "0xF000"])
        reports = [norm(json.loads(line), root) for line in capsys.readouterr().out.splitlines()
                   if line.startswith("{")]
        return reports, tokenizer_dir(str(root / "tok")), tokenizer_dir(str(root / "ext"))

    port, ref = both(tmp_path, scenario)
    assert port == ref
    (trained, extended), tok, _ = port
    assert trained["tokenizer_out"] == "<dir>/tok" and trained["vocab_size"] > K * S + 5
    assert extended["vocab_size"] == trained["vocab_size"] + 2 * 4
    assert "<|audio_start|>" in tok["tokenizer.json"]["vocab"]


def test_count_rows_cli(tmp_path, capsys):
    """``analytics.count_rows.main`` as JSON, as markdown, and with an
    estimate's tokens: printed output equals the JAX CLI's."""
    def scenario(m, root, rng):
        _group_hub(m, root)
        (root / "tokens.json").write_text(json.dumps({"en": {"estimated_total_tokens": 6}}))
        capsys.readouterr()
        hub = f"dir:{root / 'hub'}"
        m.count_rows.main(["--hub", hub])
        m.count_rows.main(["--hub", hub, "--markdown", "--group-depth", "0"])
        m.count_rows.main(["--hub", hub, "--tokens-json", str(root / "tokens.json")])
        return capsys.readouterr().out

    port, ref = both(tmp_path, scenario)
    assert port == ref
    assert '"en": {\n  "files": 1,\n  "rows": 3\n }' in port
    assert "| all | 2 | 5 |" in port and "| en | 1 | 3 | 6 |" in port and "| de | 1 | 2 | XXX |" in port


def _estimate_hub(m, root, rng):
    """Three groups of two code-char parquets each, and an alphabet-only
    tokenizer of their codec."""
    hub = m.hub.LocalHub(str(root / "hub"))
    for g in ("g0", "g1", "g2"):
        for fi in range(2):
            rows = [{"id": f"{g}_{fi}_{i}",
                     "text": m.codes.codes_to_chars(
                         rng.integers(0, S, size=(K, int(rng.integers(2, 9)))), S,
                         unicode_offset=OFF)} for i in range(12)]
            hub.upload_file(m.parquet.write_parquet(rows, str(root / "t.parquet")),
                            f"data/{g}/f{fi}.parquet")
    (root / "npys").mkdir()
    make_npy(m, root / "npys" / "c.npy", rng, K, S)
    m.trainer.CodecBPETrainer(K, S, vocab_size=K * S + 1, eos_token="<eos>",
                              max_token_codebook_ngrams=0, unicode_offset=OFF).train(
        str(root / "npys")).save_pretrained(str(root / "tok"))


def test_estimate_tokens_cli_resume_and_fingerprint(tmp_path, capsys):
    """``analytics.estimate_tokens.main`` with ``--output``: the report and
    its checkpoint file equal the JAX CLI's; a rerun resumes from the file
    (same report), a file made under other settings is refused, and
    ``--rows-distribution`` takes count_rows' output."""
    def scenario(m, root, rng):
        _estimate_hub(m, root, rng)
        argv = ["--hub", f"dir:{root / 'hub'}", "--prefix", "data/", "--tokenizer",
                str(root / "tok"), "--sample-rows", "8", "--group-depth", "2", "--seed", "5",
                "--output", str(root / "est.json")]
        capsys.readouterr()
        m.estimate_tokens.main(argv)
        first = json.loads(capsys.readouterr().out)
        saved = norm(json.loads((root / "est.json").read_text()), root)
        m.estimate_tokens.main(argv)
        again = json.loads(capsys.readouterr().out)
        with pytest.raises(SystemExit) as info:
            m.estimate_tokens.main(argv[:-4] + ["--seed", "6"] + argv[-2:])
        refused = norm(str(info.value), root)
        (root / "rows.json").write_text(json.dumps({"data/g0": {"files": 2, "rows": 240}}))
        m.estimate_tokens.main(argv[:-2] + ["--rows-distribution", str(root / "rows.json")])
        strat = json.loads(capsys.readouterr().out)
        return first, saved, again, refused, strat

    port, ref = both(tmp_path, scenario)
    assert port == ref
    first, saved, again, refused, strat = port
    assert sorted(first) == ["data/g0", "data/g1", "data/g2"] and again == first
    assert {k: v for k, v in saved.items() if k != "_config"} == first
    assert saved["_config"]["sample_rows"] == 8 and "different settings" in refused
    assert strat["data/g0"]["total_rows"] == 240 and first["data/g0"]["total_rows"] == 24


class _Tok4:
    """A tokenizer with transformers 4's add_special_tokens keyword."""

    def __init__(self):
        self.calls = []

    def add_tokens(self, tokens):
        self.calls.append(("add_tokens", tokens))

    def add_special_tokens(self, special_tokens_dict, replace_additional_special_tokens=True):
        self.calls.append(("add_special_tokens", special_tokens_dict,
                           {"replace_additional_special_tokens":
                            replace_additional_special_tokens}))


class _Tok5(_Tok4):
    """transformers 5's: the keyword renamed, the old one refused."""

    def add_special_tokens(self, special_tokens_dict, replace_extra_special_tokens=True):
        self.calls.append(("add_special_tokens", special_tokens_dict,
                           {"replace_extra_special_tokens": replace_extra_special_tokens}))


@pytest.mark.parametrize("cls, keyword", [(_Tok4, "replace_additional_special_tokens"),
                                          (_Tok5, "replace_extra_special_tokens")])
def test_extend_tokenizer_extends_specials_on_transformers_4_and_5(cls, keyword):
    """extend_tokenizer adds the specials without replacing the tokenizer's
    own extra specials under either keyword: transformers 4's
    replace_additional_special_tokens, or 5's replace_extra_special_tokens
    (transformers 5.5.0 refuses the 4.x keyword)."""
    from tokenize_audio_tpu_torch.bpe.trainer import extend_tokenizer

    tok = cls()
    assert extend_tokenizer(tok, 2, 2, OFF, ["<a>", "<b>"]) is tok
    assert tok.calls == [("add_tokens", [chr(OFF + i) for i in range(4)]),
                         ("add_special_tokens", {"additional_special_tokens": ["<a>", "<b>"]},
                          {keyword: False})]
