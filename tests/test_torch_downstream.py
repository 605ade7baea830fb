"""PyTorch port, the downstream chain: a tiny cut of tests/test_full_stack.py
in tier 1. The port's CPU YODAS2 encode (tiny oracle config) -> pretrain
parquet -> the five derivative modes -> sampler -> trainer -> validate, count
and estimate, on one LocalHub tree, held stage by stage equal to the same
chain of the JAX package (its codes from the JAX engine on the same oracle);
and every downstream command line's flags against the JAX module's."""

import importlib
import os
import tempfile

import pytest

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tests.test_yodas2 import build_corpus
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.datasets import yodas2 as jax_yodas2
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from torch_downstream import (
    JAX,
    PORT,
    assert_chains_equal,
    check_chain,
    cli_flags,
    parser_of,
    run_chain,
)
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.datasets import yodas2
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

ENGINE_KW = dict(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0)
SUBSHARDS = ["00000000", "00000001"]


def test_tiny_chain_equals_jax(tmp_path):
    import numpy as np

    model, params, jcfg = make_oracle(tiny_hf_config())
    mirror = build_corpus(str(tmp_path / "mirror"), np.random.default_rng(0), subshards=2,
                          audios_per=1)
    trainer_kw = dict(num_codebooks=8, codebook_size=2048, vocab_size=8 * 2048 + 24,
                      min_frequency=2, eos_token="<|end_of_text|>", max_token_codebook_ngrams=1,
                      unicode_offset=0xE000)
    engines = {
        "port": MimiEncoderEngine(params, config_from_hf(model.config),
                                  EngineConfig(**ENGINE_KW), num_codebooks=12, device="cpu"),
        "jax": JaxEngine(params, jcfg, JaxEngineConfig(**ENGINE_KW), num_codebooks=12),
    }
    chains = {}
    for m, processor in ((PORT, yodas2), (JAX, jax_yodas2)):
        root = tmp_path / m.name
        root.mkdir()
        chains[m.name] = run_chain(m, processor, engines[m.name], root, mirror, SUBSHARDS,
                                   trainer_kw, sample_rows=64, parquet_rows=3)
    (port, tok), (ref, _) = chains["port"], chains["jax"]
    assert port["encode"]["processed"] == 2 and port["encode"]["failed"] == 0
    assert port["convert"] == {"processed": 2, "skipped": 0, "failed": 0}
    assert [len(rows) for rows in port["pretrain"].values()] == [3, 1]
    assert_chains_equal(port, ref)
    check_chain(port, tok, n_audios=2)
    assert len(tok) >= 8 * 2048 + 1


MODULES = ["datasets.pretrain_converter", "datasets.derivatives", "datasets.cvss",
           "bpe.sampler", "bpe.trainer", "bpe.surgery", "analytics.count_rows",
           "analytics.estimate_tokens", "analytics.validate"]


@pytest.mark.parametrize("name", MODULES)
def test_cli_flags_match_jax(name):
    """Each downstream command line has the JAX module's flags with the same
    dests, defaults, requiredness, nargs, choices and actions; the port's
    converters put their default work dir under the temp directory, and
    surgery adds ``--device``."""
    port = cli_flags(parser_of(importlib.import_module(f"tokenize_audio_tpu_torch.{name}")))
    ref = cli_flags(parser_of(importlib.import_module(f"tokenize_audio_tpu.{name}")))
    if name == "bpe.surgery":
        assert port.pop("--device") == ("device", None, False, None, None, "_StoreAction")
    if "--work-dir" in ref:  # the JAX CLI's /tmp/<name>, under the temp directory (TMPDIR)
        name = os.path.basename(ref.pop("--work-dir")[1])
        assert port.pop("--work-dir")[1] == os.path.join(tempfile.gettempdir(), name)
    assert port == ref
