"""PyTorch port, full stack (slow, as tests/test_full_stack.py is): the port's
YODAS2 encode (tiny oracle config, on the CPU) -> pretrain parquet ->
asr/acoustic/semantic derivatives -> sampler and the 16k no-merge trainer ->
validate, count and estimate, on one LocalHub tree, held stage by stage equal
to the same chain of the JAX package on the same mirror and oracle, with
test_full_stack.py's cross-layer checks on the port's chain."""

import numpy as np
import pytest

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tests.test_yodas2 import build_corpus
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.datasets import yodas2 as jax_yodas2
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from torch_downstream import JAX, PORT, assert_chains_equal, check_chain, run_chain
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.datasets import yodas2
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

ENGINE_KW = dict(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0)


@pytest.mark.slow
def test_full_stack_l2_to_l5(tmp_path):
    subshards = ["00000000", "00000001"]
    mirror = build_corpus(str(tmp_path / "mirror"), np.random.default_rng(0), subshards=2,
                          audios_per=2)
    model, params, jcfg = make_oracle(tiny_hf_config())
    engines = {
        "port": MimiEncoderEngine(params, config_from_hf(model.config),
                                  EngineConfig(**ENGINE_KW), num_codebooks=12, device="cpu"),
        "jax": JaxEngine(params, jcfg, JaxEngineConfig(**ENGINE_KW), num_codebooks=12),
    }
    trainer_kw = dict(num_codebooks=8, codebook_size=2048, vocab_size=8 * 2048 + 1,
                      eos_token="<|end_of_text|>", max_token_codebook_ngrams=0,
                      unicode_offset=0xE000)  # the 16k no-merge recipe
    chains = {}
    for m, processor in ((PORT, yodas2), (JAX, jax_yodas2)):
        root = tmp_path / m.name
        root.mkdir()
        chains[m.name] = run_chain(m, processor, engines[m.name], root, mirror, subshards,
                                   trainer_kw, modes=("asr", "acoustic", "semantic"))
    (port, tok), (ref, _) = chains["port"], chains["jax"]
    assert port["encode"]["processed"] == 2 and port["encode"]["failed"] == 0
    assert port["convert"] == {"processed": 2, "skipped": 0, "failed": 0}
    assert len(port["pretrain"]) == 2  # a mid-run rollover and a final flush
    assert_chains_equal(port, ref)
    check_chain(port, tok, n_audios=4)
    assert len(tok) == 8 * 2048 + 1
    est = port["estimate"]["all"]
    assert est["sampled_rows"] > 0 and est["estimated_total_tokens"] > 0
