"""Shared scaffolding for the PyTorch port's downstream tests (the pretrain
converter, derivatives, CVSS, codec BPE and analytics): each case runs
through the port and through the JAX package, on the same inputs made from a
seed, and the two runs' outputs are held exactly equal. Imported by name,
with ``tests/`` on ``sys.path`` as pytest puts it there."""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace
from unittest import mock

import numpy as np

from tokenize_audio_tpu import analytics as jax_analytics
from tokenize_audio_tpu import bpe as jax_bpe
from tokenize_audio_tpu import config as jax_config
from tokenize_audio_tpu import hub as jax_hub
from tokenize_audio_tpu.analytics import count_rows as jax_count_rows
from tokenize_audio_tpu.analytics import estimate_tokens as jax_estimate_tokens
from tokenize_audio_tpu.analytics import validate as jax_validate
from tokenize_audio_tpu.bpe import sampler as jax_sampler
from tokenize_audio_tpu.bpe import surgery as jax_surgery
from tokenize_audio_tpu.bpe import trainer as jax_trainer
from tokenize_audio_tpu.core import codes as jax_codes
from tokenize_audio_tpu.datasets import base as jax_base
from tokenize_audio_tpu.datasets import cvss as jax_cvss
from tokenize_audio_tpu.datasets import derivatives as jax_derivatives
from tokenize_audio_tpu.datasets import parquet_utils as jax_parquet_utils
from tokenize_audio_tpu.datasets import pretrain_converter as jax_pretrain_converter
from tokenize_audio_tpu_torch import analytics, bpe, config, hub
from tokenize_audio_tpu_torch.analytics import count_rows, estimate_tokens, validate
from tokenize_audio_tpu_torch.bpe import sampler, surgery, trainer
from tokenize_audio_tpu_torch.core import codes
from tokenize_audio_tpu_torch.datasets import base, cvss, derivatives, parquet_utils
from tokenize_audio_tpu_torch.datasets import pretrain_converter

PORT = SimpleNamespace(
    name="port", analytics=analytics, bpe=bpe, config=config, hub=hub, count_rows=count_rows,
    estimate_tokens=estimate_tokens, validate=validate, sampler=sampler, surgery=surgery,
    trainer=trainer, codes=codes, base=base, cvss=cvss, derivatives=derivatives,
    parquet=parquet_utils, converter=pretrain_converter,
)
JAX = SimpleNamespace(
    name="jax", analytics=jax_analytics, bpe=jax_bpe, config=jax_config, hub=jax_hub,
    count_rows=jax_count_rows, estimate_tokens=jax_estimate_tokens, validate=jax_validate,
    sampler=jax_sampler, surgery=jax_surgery, trainer=jax_trainer, codes=jax_codes,
    base=jax_base, cvss=jax_cvss, derivatives=jax_derivatives, parquet=jax_parquet_utils,
    converter=jax_pretrain_converter,
)


def both(tmp_path, scenario, seed=0):
    """``scenario(m, root, rng)`` for the port and then the JAX package, each
    in a directory of its own with a generator seeded alike; returns
    ``(port_result, jax_result)``."""
    out = []
    for m in (PORT, JAX):
        root = tmp_path / m.name
        root.mkdir()
        out.append(scenario(m, root, np.random.default_rng(seed)))
    return tuple(out)


def parquet_tree(m, root) -> dict:
    """Every parquet under ``root``: relative path -> rows, read back by the
    package's own reader (rows, never bytes: a file carries the writer's
    pandas and pyarrow versions)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".parquet"):
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, root)] = m.parquet.read_parquet(path)
    return out


def json_tree(root) -> dict:
    """Every JSON file under ``root``: relative path -> content, with the
    progress ledgers' write time taken out."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".json"):
                with open(os.path.join(dirpath, name)) as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    data.pop("updated_at", None)
                out[os.path.relpath(os.path.join(dirpath, name), root)] = data
    return out


def npy_tree(root) -> dict:
    """Every .npy under ``root``: name -> list of (dtype, array) of its
    object array's items (or of the array itself)."""
    out = {}
    for name in sorted(os.listdir(root)):
        if name.endswith(".npy"):
            data = np.load(os.path.join(root, name), allow_pickle=True)
            items = list(data) if data.dtype == object else [data]
            out[name] = [(np.asarray(a).dtype.str, np.asarray(a)) for a in items]
    return out


def assert_npy_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for (gd, ga), (wd, wa) in zip(got[name], want[name]):
            assert gd == wd and np.array_equal(ga, wa), name


def tokenizer_parts(tok_json: dict) -> dict:
    """A tokenizer.json's vocab, merges and added tokens."""
    return {"vocab": tok_json["model"]["vocab"], "merges": tok_json["model"]["merges"],
            "added_tokens": tok_json["added_tokens"], "decoder": tok_json["decoder"]}


def tokenizer_of(tok) -> dict:
    """The parsed vocab and merges of an in-memory fast tokenizer."""
    return tokenizer_parts(json.loads(tok.backend_tokenizer.to_str()))


def tokenizer_dir(path) -> dict:
    """A saved tokenizer directory: tokenizer.json parsed to its vocab and
    merges, and every other JSON file parsed whole."""
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            data = json.load(f)
        out[name] = tokenizer_parts(data) if name == "tokenizer.json" else data
    return out


def norm(obj, root):
    """``obj`` with the run's directory replaced, for comparing printed and
    returned reports that name their output paths."""
    return json.loads(json.dumps(obj).replace(str(root), "<dir>"))


class WSTok:
    """A whitespace "tokenizer" with the HF ``encode`` interface."""

    def encode(self, t):
        return t.split()


def make_npy(m, path, rng, k, s, n_utts=40, frames=64):
    """An object-array .npy of ``n_utts`` (k, frames) uint16 code arrays, the
    first half biased so BPE has frequent pairs to merge."""
    arrays = [rng.integers(0, s, size=(k, frames), dtype=np.uint16) for _ in range(n_utts)]
    for a in arrays[: n_utts // 2]:
        a[:, ::2] = 3
    obj = np.empty(len(arrays), dtype=object)
    obj[:] = arrays
    np.save(str(path), obj, allow_pickle=True)
    return str(path), arrays


class _Parsed(Exception):
    pass


def parser_of(mod, argv=()):
    """The ArgumentParser a module's ``main`` builds, caught when it parses
    (nothing after the parse runs)."""
    caught = []

    def catch(self, args=None, namespace=None):
        caught.append(self)
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch):
        try:
            mod.main(list(argv))
        except _Parsed:
            pass
    return caught[0]


def cli_flags(parser) -> dict:
    """A parser's flags: option string -> (dest, default, required, nargs,
    choices, action class name)."""
    return {opt: (a.dest, a.default, a.required, a.nargs, a.choices, type(a).__name__)
            for a in parser._actions for opt in a.option_strings}


AUDIO_START, AUDIO_END = "<|audio_start|>", "<|audio_end|>"
DERIVATIVE_MODES = ("asr", "acoustic", "semantic", "tts0", "fix")


def audio_spans(text):
    out, rest = [], text
    while AUDIO_START in rest:
        _, rest = rest.split(AUDIO_START, 1)
        span, rest = rest.split(AUDIO_END, 1)
        out.append(span)
    return out


def run_chain(m, yodas2, engine, root, mirror, subshards, trainer_kw, modes=DERIVATIVE_MODES,
              sample_rows=64, parquet_rows=5):
    """The downstream chain of one package on one LocalHub tree: the YODAS2
    processor ``yodas2`` with ``engine`` over ``mirror`` -> pretrain parquet
    -> derivatives in ``modes`` -> sampler -> trainer (``trainer_kw``) ->
    validate, count and estimate. Returns (stage outputs, tokenizer)."""
    out = {}
    hub = m.hub.LocalHub(str(root / "hub"))
    out["encode"] = yodas2.Yodas2ShardProcessor(
        "en000", yodas2.LocalSource(mirror), hub, engine, str(root / "work"),
        str(root / "prog"), max_subshards=len(subshards), max_consecutive_missing=2,
        upload_batch_size=1, save_every=1,
    ).process()
    out["hub_json"] = json_tree(root / "hub")
    out["convert"] = m.converter.PretrainShardConverter(
        "en000", hub, hub, str(root / "conv_work"), str(root / "conv_prog"),
        parquet_rows=parquet_rows, upload_batch_size=1,  # a mid-run rollover, a final flush
    ).run(subshards, source_prefix="data/")
    out["pretrain"] = parquet_tree(m, root / "hub")
    out["convert_progress"] = json_tree(root / "conv_prog")
    for mode in modes:
        rep = m.derivatives.process_shards(
            mode, hub, m.hub.LocalHub(str(root / f"hub_{mode}")), str(root / f"prog_{mode}"),
            str(root / f"work_{mode}"), prefix="data/", upload_batch_size=1)
        out[f"derive_{mode}"] = ({k: v for k, v in vars(rep).items() if k != "wall_seconds"},
                                 parquet_tree(m, root / f"hub_{mode}"))
    picks = m.sampler.pick_subshards({"en000": subshards}, per_shard=2, seed=7)
    out["sample"] = m.sampler.CodeSampler(hub, str(root / "npys"), num_codebooks=8).sample(picks)
    out["npys"] = npy_tree(str(root / "npys"))
    tok = m.trainer.CodecBPETrainer(**trainer_kw).train(str(root / "npys"))
    out["tokenizer"] = tokenizer_of(tok)
    rows = [r for rs in out["pretrain"].values() for r in rs]
    out["validate"] = m.validate.validate_rows(rows, 8)
    out["count"] = m.count_rows.count_hub_dataset(hub, "data/", group_depth=0)
    out["estimate"] = m.estimate_tokens.TokenEstimator(tok).estimate_hub_dataset(
        hub, prefix="data/", sample_rows=sample_rows)
    return out, tok


def assert_chains_equal(port: dict, ref: dict) -> None:
    """Every stage of the port's chain equals the JAX chain's."""
    assert sorted(port) == sorted(ref)
    assert_npy_equal(port["npys"], ref["npys"])
    for stage in port:
        if stage != "npys":
            assert port[stage] == ref[stage], stage


def check_chain(out: dict, tok, n_audios: int) -> None:
    """What each stage must hold on its own (tests/test_full_stack.py's
    cross-layer checks): the converter's spans decode to the encode's codes,
    the QA gate passes, the derivatives keep type2/type1 rows, semantic is
    acoustic's every 8th char, the sampler's corpus is the hub's codes cut
    to 8 books, and the tokenizer round-trips every span."""
    from tokenize_audio_tpu_torch.core.codes import codes_to_chars

    raw = {}
    for path, entries in out["hub_json"].items():
        if path.endswith(".json") and path.startswith("data/"):
            for e in entries:
                raw[e["audio_id"]] = [np.asarray(c, dtype=np.int32)
                                      for c in e["codes"].values() if c]
    assert len(raw) == n_audios
    rows = [r for rs in out["pretrain"].values() for r in rs]
    assert len(rows) == 2 * n_audios and out["validate"]["bad_rows"] == 0
    for r in rows:
        aid = r["id"].rsplit("_", 1)[0]
        assert audio_spans(r["text"]) == [
            codes_to_chars(c[:8], 2048, unicode_offset=0xE000) for c in raw[aid]]
    type2 = {r["id"][: -len("_type2")] for r in rows if r["id"].endswith("_type2")}
    for mode in ("asr", "acoustic", "semantic"):
        derived = [r for rs in out[f"derive_{mode}"][1].values() for r in rs]
        assert sorted(r["id"] for r in derived) == sorted(type2)
    acoustic = {r["id"]: r["text"] for rs in out["derive_acoustic"][1].values() for r in rs}
    for rs in out["derive_semantic"][1].values():
        for r in rs:
            assert "<|text_start|>" not in acoustic[r["id"]]
            assert audio_spans(r["text"]) == [s[::8] for s in audio_spans(acoustic[r["id"]])]
    corpus = [a for items in out["npys"].values() for _, a in items]
    assert sum(len(v) for v in raw.values()) == len(corpus)
    assert {a.tobytes() for a in corpus} == {c[:8].astype(np.uint16).tobytes()
                                             for v in raw.values() for c in v}
    for r in rows:
        for span in audio_spans(r["text"]):
            assert tok.decode(tok.encode(span)) == span
    assert out["count"] == {"all": {"files": len(out["pretrain"]), "rows": len(rows)}}
    assert out["estimate"]["all"]["total_rows"] == len(rows)
