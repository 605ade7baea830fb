"""PyTorch port, downstream converters: the pretrain-parquet converter, the
derivative datasets and the CVSS combiner against the JAX package's (the
cases of tests/test_pretrain_converter.py, test_derivatives.py and
test_cvss.py under the same names). Each case runs through both packages on
the same seeded inputs, and their parquet rows (read back as rows),
progress ledgers, checkpoint JSONs and reports must be exactly equal; the
JAX tests' own outcomes are held on the port's run."""

import json
import os

import numpy as np
import pytest

from torch_downstream import both, json_tree, parquet_tree

CODEBOOK_SIZE, OFF = 2048, 0xE000


# ---- pretrain converter (tests/test_pretrain_converter.py) ----


def make_entry(rng, audio_id, n_chunks=2, frames=3, k=32):
    text, codes = {}, {}
    for c in range(n_chunks):
        cid = f"{audio_id}-{c:05d}-000-100"
        text[cid] = f"chunk text {c}"
        codes[cid] = rng.integers(0, CODEBOOK_SIZE, size=(k, frames)).tolist()
    return {"audio_id": audio_id, "text": text, "codes": codes}


def _put_subshards(m, src, root, rng, shard="en000", n=4, entries_per=3):
    for i in range(n):
        sid = f"{i:08d}"
        data = [make_entry(rng, f"{shard}-{sid}-a{j}") for j in range(entries_per)]
        p = str(root / f"{sid}.json")
        with open(p, "w") as f:
            json.dump(data, f)
        src.upload_file(p, f"{shard}/{sid}.json")
    return [f"{i:08d}" for i in range(n)]


def _hubs(m, root):
    return m.hub.LocalHub(str(root / "src")), m.hub.LocalHub(str(root / "dst"))


def _state(m, root):
    """What a converter run leaves: the target hub's rows, the progress
    ledger and the work dir's checkpoint and counter."""
    return {"dst": parquet_tree(m, root / "dst"), "prog": json_tree(root / "prog"),
            "work": json_tree(root / "work"),
            "work_files": sorted(os.listdir(root / "work"))}


def _add(m, src, conv, root, sid):
    local = str(root / "work" / f"{sid}.json")
    src.download(f"en000/{sid}.json", local)
    with open(local) as f:
        conv.add_subshard(sid, json.load(f))


def test_document_to_rows(tmp_path):
    def scenario(m, root, rng):
        e = make_entry(rng, "vid0")
        return e, m.converter.document_to_rows(e, "en000/00000000"), (
            m.converter.document_to_rows({"audio_id": "x", "text": {}, "codes": {}}, "s"),
            m.converter.document_to_rows({"audio_id": "x"}, "s"))

    port, ref = both(tmp_path, scenario)
    assert port == ref
    e, (r1, r2), empties = port
    assert r1["id"] == "vid0_type1" and r2["id"] == "vid0_type2"
    assert r1["split"] == "en000/00000000"
    from tokenize_audio_tpu_torch.core.codes import chars_to_codes

    span = r1["text"].split("<|audio_start|>")[1].split("<|audio_end|>")[0]
    got = np.array(chars_to_codes(span, 8, CODEBOOK_SIZE, return_tensors="np",
                                  unicode_offset=OFF))
    np.testing.assert_array_equal(got, np.array(e["codes"][next(iter(e["codes"]))])[:8])
    assert empties == ((None, None), (None, None))


def test_converter_accumulates_and_uploads(tmp_path):
    def scenario(m, root, rng):
        src, dst = _hubs(m, root)
        sids = _put_subshards(m, src, root, rng)
        conv = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=10, upload_batch_size=1, checkpoint_interval=1,
        )
        rep = conv.run(sids)
        files, first = dst.list_files("data/"), _state(m, root)
        conv2 = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"), parquet_rows=10
        )
        return rep, files, first, conv2.run(sids), dst.list_files("data/"), _state(m, root)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    rep, files, first, rep2, files2, _ = port
    assert rep == {"processed": 4, "skipped": 0, "failed": 0}
    assert files == [f"data/en000-0000{i}.parquet" for i in range(3)]
    assert sum(len(rows) for rows in first["dst"].values()) == 4 * 3 * 2
    assert rep2 == {"processed": 0, "skipped": 4, "failed": 0}
    assert files2 == files
    assert first["work"]["en000.parquet_counter.json"] == {"next": 3}


def test_converter_crash_resume_no_duplicates(tmp_path):
    def scenario(m, root, rng):
        src, dst = _hubs(m, root)
        sids = _put_subshards(m, src, root, rng, n=3)
        conv = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=1000, upload_batch_size=99, checkpoint_interval=1,
        )
        for sid in sids[:2]:
            _add(m, src, conv, root, sid)
        crashed = (dst.list_files("data/"), _state(m, root))
        conv2 = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=1000, upload_batch_size=1,
        )
        return crashed, conv2.run(sids), _state(m, root)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    (crashed_files, crashed), rep, state = port
    assert crashed_files == [] and len(crashed["work"]["en000.accum.json"]["rows"]) == 12
    assert rep["processed"] == 1 and rep["skipped"] == 2
    (rows,) = state["dst"].values()
    assert len(rows) == 3 * 3 * 2
    assert len({r["id"] for r in rows}) == len(rows)


def test_converter_failed_subshard_isolated(tmp_path):
    def scenario(m, root, rng):
        src, dst = _hubs(m, root)
        sids = _put_subshards(m, src, root, rng, n=2)
        conv = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"), upload_batch_size=1
        )
        return conv.run(sids + ["99999999"]), _state(m, root)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    rep, state = port
    assert rep["processed"] == 2 and rep["failed"] == 1
    assert state["prog"]["pretrain_en000_progress.json"]["failed"] == ["99999999"]


def test_orphan_parquet_requeued(tmp_path):
    def scenario(m, root, rng):
        src, dst = _hubs(m, root)
        sids = _put_subshards(m, src, root, rng, n=2)
        conv = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=6, upload_batch_size=99, checkpoint_interval=1,
        )
        for sid in sids:
            _add(m, src, conv, root, sid)
        crashed = (dst.list_files("data/"), _state(m, root))
        conv2 = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=6, upload_batch_size=1,
        )
        return crashed, conv2.run(sids), _state(m, root)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    (crashed_files, crashed), rep, state = port
    assert crashed_files == [] and any(f.endswith(".parquet") for f in crashed["work_files"])
    assert rep["failed"] == 0
    rows = [r for rs in state["dst"].values() for r in rs]
    assert len(rows) == 2 * 3 * 2 and len({r["id"] for r in rows}) == len(rows)


def test_post_checkpoint_orphan_discarded_no_duplicates(tmp_path):
    def scenario(m, root, rng):
        src, dst = _hubs(m, root)
        sids = _put_subshards(m, src, root, rng, n=1)
        conv = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=1000, upload_batch_size=99, checkpoint_interval=1,
        )
        _add(m, src, conv, root, sids[0])
        conv._emit_parquet(list(conv.rows))  # emitted, then a crash before the trim
        crashed = _state(m, root)
        conv2 = m.converter.PretrainShardConverter(
            "en000", src, dst, str(root / "work"), str(root / "prog"),
            parquet_rows=1000, upload_batch_size=1,
        )
        return crashed, conv2.run(sids), _state(m, root)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    crashed, _, state = port
    assert any(f.endswith(".parquet") for f in crashed["work_files"])
    rows = [r for rs in state["dst"].values() for r in rs]
    assert len(rows) == 1 * 3 * 2 and len({r["id"] for r in rows}) == len(rows)


def test_converter_cli_and_rerun(tmp_path, capsys):
    """``main`` with an @file of sub-shard ids (one missing), then again: the
    printed reports, the hub's rows and the ledgers equal the JAX CLI's,
    and the rerun uploads nothing."""
    def scenario(m, root, rng):
        src, dst = _hubs(m, root)
        sids = _put_subshards(m, src, root, rng, n=3)
        (root / "ids.txt").write_text("\n".join(sids + ["99999999"]) + "\n")
        argv = ["--shard-id", "en000", "--subshard-ids", f"@{root / 'ids.txt'}",
                "--source-hub", f"dir:{root / 'src'}", "--target-hub", f"dir:{root / 'dst'}",
                "--work-dir", str(root / "work"), "--progress-dir", str(root / "prog"),
                "--parquet-rows", "7"]
        capsys.readouterr()
        m.converter.main(argv)
        first = (capsys.readouterr().out, _state(m, root))
        m.converter.main(argv)
        return first, capsys.readouterr().out, _state(m, root)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    (out, state), rerun_out, rerun_state = port
    assert json.loads(out) == {"processed": 3, "skipped": 0, "failed": 1}
    assert json.loads(rerun_out) == {"processed": 0, "skipped": 3, "failed": 1}
    assert rerun_state["dst"] == state["dst"] and len(state["dst"]) == 3


# ---- derivatives (tests/test_derivatives.py) ----


def make_audio_str(m, rng, frames=5):
    codes = rng.integers(0, CODEBOOK_SIZE, size=(8, frames), dtype=np.int64)
    return codes, m.codes.codes_to_chars(codes, CODEBOOK_SIZE, unicode_offset=OFF)


def test_filter_and_strip_suffix(tmp_path):
    rows = [{"id": "a_type1", "text": "t1"}, {"id": "a_type2", "text": "t2"},
            {"id": "b_type2", "text": "t3"}]
    port, ref = both(tmp_path, lambda m, root, rng: (
        m.derivatives.filter_type2(rows), m.derivatives.filter_type1(rows)))
    assert port == ref
    assert port == ([{"id": "a", "text": "t2"}, {"id": "b", "text": "t3"}],
                    [{"id": "a", "text": "t1"}])


def test_remove_text_and_semantic(tmp_path):
    def scenario(m, root, rng):
        codes, audio_str = make_audio_str(m, rng)
        doc = m.base.asr_document("hello", audio_str)
        stripped = m.derivatives.remove_text_content(doc)
        return codes, audio_str, stripped, m.derivatives.extract_semantic_tokens(stripped, "ex0")

    port, ref = both(tmp_path, scenario)
    assert port[1:] == ref[1:] and np.array_equal(port[0], ref[0])
    codes, audio_str, stripped, sem = port
    assert "<|text_start|>" not in stripped and "hello" not in stripped
    assert audio_str in stripped
    span = sem.split("<|audio_start|>")[1].split("<|audio_end|>")[0]
    assert [ord(c) - OFF for c in span] == codes[0].tolist()


def test_semantic_rejects_partial_frames(tmp_path):
    bad = "<|audio_start|>" + "" * 7 + "<|audio_end|>"

    def scenario(m, root, rng):
        with pytest.raises(ValueError, match="divisible") as info:
            m.derivatives.extract_semantic_tokens(bad, "ex1")
        return str(info.value)

    port, ref = both(tmp_path, scenario)
    assert port == ref


def test_tts0_and_fix(tmp_path):
    def scenario(m, root, rng):
        _, audio_str = make_audio_str(m, rng)
        doc = m.base.tts_document("hi there", audio_str)
        dirty = doc.replace("<|text_start|>", "<|text_start|> ").replace(
            "<|text_end|>", " <|text_end|>")
        return doc, m.derivatives.inject_speaker_tag(doc), m.derivatives.fix_text_whitespace(dirty)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    doc, tagged, fixed = port
    assert "<|text_start|>[0]hi there<|text_end|>" in tagged
    assert fixed == doc


def _derive(m, root, rng, mode, rows=None):
    src, dst = _hubs(m, root)
    if rows is None:
        _, audio_str = make_audio_str(m, rng)
        rows = [{"id": "u0_type1", "text": m.base.tts_document("a", audio_str)},
                {"id": "u0_type2", "text": m.base.asr_document("a", audio_str)}]
    src.upload_file(m.parquet.write_parquet(rows, str(root / "s0.parquet")), "data/s0.parquet")
    reps = []
    for _ in range(2):
        rep = m.derivatives.process_shards(mode, src, dst, str(root / "prog"), str(root / "work"))
        reps.append({k: v for k, v in vars(rep).items() if k != "wall_seconds"})
    return reps, parquet_tree(m, root / "dst"), json_tree(root / "prog")


def test_process_shards_hub_to_hub(tmp_path):
    port, ref = both(tmp_path, lambda m, root, rng: _derive(m, root, rng, "semantic"))
    assert port == ref
    (rep, rep2), tree, _ = port
    assert rep["processed"] == 1 and rep2["skipped"] == 1
    out = tree["data/s0.parquet"]
    assert [r["id"] for r in out] == ["u0"] and "<|text_start|>" not in out[0]["text"]
    assert len(out[0]["text"].split("<|audio_start|>")[1].split("<|audio_end|>")[0]) == 5


def test_transform_rows_fix_mode(tmp_path):
    rows = [{"id": "x_type1", "text": "<|text_start|> padded <|text_end|>"}]

    def scenario(m, root, rng):
        with pytest.raises(ValueError, match="unknown mode") as info:
            m.derivatives.transform_rows(rows, "nope")
        return m.derivatives.transform_rows(rows, "fix"), str(info.value)

    port, ref = both(tmp_path, scenario)
    assert port == ref
    assert port[0][0]["text"] == "<|text_start|>padded<|text_end|>"


@pytest.mark.parametrize("mode", ["asr", "acoustic", "tts0", "fix"])
def test_derivatives_cli_modes(tmp_path, mode):
    """``main`` in each other mode over a two-document parquet: the returned
    report, the target rows and the ledger equal the JAX CLI's."""
    def scenario(m, root, rng):
        docs = []
        for i in range(2):
            _, audio_str = make_audio_str(m, rng, frames=3 + i)
            docs += [{"id": f"u{i}_type1", "text": m.base.tts_document(f"t {i}", audio_str)},
                     {"id": f"u{i}_type2", "text": m.base.asr_document(f"t {i} ", audio_str)}]
        src = m.hub.LocalHub(str(root / "src"))
        src.upload_file(m.parquet.write_parquet(docs, str(root / "s.parquet")), "data/s.parquet")
        rep = m.derivatives.main(["--mode", mode, "--source-hub", f"dir:{root / 'src'}",
                                  "--target-hub", f"dir:{root / 'dst'}",
                                  "--progress-dir", str(root / "prog"),
                                  "--work-dir", str(root / "work")])
        rep = {k: v for k, v in vars(rep).items() if k != "wall_seconds"}
        return rep, parquet_tree(m, root / "dst"), json_tree(root / "prog")

    port, ref = both(tmp_path, scenario)
    assert port == ref
    assert port[0]["processed"] == 1 and len(port[1]["data/s.parquet"]) == (
        4 if mode == "fix" else 2)


# ---- CVSS (tests/test_cvss.py) ----


def test_language_list_matches_reference(tmp_path):
    port, ref = both(tmp_path, lambda m, root, rng: (m.cvss.LANGUAGES, m.cvss.SPLITS))
    assert port == ref
    assert len(port[0]) == 21 and "sv-SE" in port[0] and "zh-CN" in port[0]


def test_combine_row(tmp_path):
    row = {"id": "x1", "original_text": "bonjour", "original_audio_str": "FR",
           "translated_text": "hello", "translated_audio_str": "EN"}
    port, ref = both(tmp_path, lambda m, root, rng: m.cvss.combine_row(row, "fr"))
    assert port == ref == (
        "<|begin_of_text|>"
        "<|audio_start|>FR<|audio_end|>"
        "<|text_start|><language>fr</language>bonjour<|text_end|>"
        "<|text_start|><language>en</language>hello<|text_end|>"
        "<|audio_start|>EN<|audio_end|>"
        "<|end_of_text|>"
    )


def _cvss_source(m, root, rng, langs=("fr", "de"), split="test", n=1):
    src = m.hub.LocalHub(str(root / "src"))
    for lang in langs:
        rows = []
        for i in range(n):
            _, a = make_audio_str(m, rng, frames=2 + i)
            _, b = make_audio_str(m, rng, frames=3 + i)
            rows.append({"id": f"{lang}-{i}", "original_text": f"{lang} {i}",
                         "original_audio_str": a, "translated_text": f"en {i}",
                         "translated_audio_str": b})
        local = m.parquet.write_parquet(rows, str(root / f"{lang}.parquet"))
        src.upload_file(local, f"{lang}/{split}.parquet")
    return src


def test_combine_split(tmp_path):
    def scenario(m, root, rng):
        src = _cvss_source(m, root, rng)
        dst = m.hub.LocalHub(str(root / "dst"))
        rep = m.cvss.combine_split("test", ["fr", "de", "ja"], src, dst, str(root / "w"))
        rep2 = m.cvss.combine_split("test", ["fr"], src, dst, str(root / "w"))
        return rep, rep2, parquet_tree(m, root / "dst")

    port, ref = both(tmp_path, scenario)
    assert port == ref
    rep, rep2, tree = port
    assert rep["status"] == "processed" and rep["rows"] == 2 and rep2["status"] == "skipped"
    assert sorted(r["lang"] for r in tree["data/test.parquet"]) == ["de", "fr"]


def test_cvss_cli(tmp_path, capsys):
    """``main`` over two languages and two splits (one split absent for
    both): the printed reports and rows equal the JAX CLI's."""
    def scenario(m, root, rng):
        _cvss_source(m, root, rng, split="train", n=2)
        capsys.readouterr()
        m.cvss.main(["--source-hub", f"dir:{root / 'src'}", "--target-hub", f"dir:{root / 'dst'}",
                     "--work-dir", str(root / "w"), "--languages", "fr", "de",
                     "--splits", "train", "test"])
        return json.loads(capsys.readouterr().out), parquet_tree(m, root / "dst")

    port, ref = both(tmp_path, scenario)
    assert port == ref
    reports, tree = port
    assert reports == [{"split": "train", "status": "processed", "rows": 4},
                       {"split": "test", "status": "processed", "rows": 0}]
    assert [r["id"] for r in tree["data/train.parquet"]] == ["fr-0", "fr-1", "de-0", "de-1"]
