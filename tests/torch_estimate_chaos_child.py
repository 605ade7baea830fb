"""Child process for the port's token-estimator SIGKILL chaos test
(test_torch_downstream_chaos): the port's ``analytics.estimate_tokens`` CLI
(--output checkpoint mode) over the seeded 24-group parquet hub of
tests/estimate_chaos_child.py, with an alphabet-only tokenizer built by the
port's trainer. Prints READY before estimation starts and DONE on
completion. Run only by tests/test_torch_downstream_chaos.py. Imports
nothing of JAX or the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = [f"lang{n:02d}" for n in range(24)]


def build_tokenizer(tokdir):
    """Alphabet-only codec tokenizer, saved for AutoTokenizer; idempotent."""
    if os.path.isfile(os.path.join(tokdir, "tokenizer_config.json")):
        return
    import numpy as np

    from tokenize_audio_tpu_torch.bpe.trainer import CodecBPETrainer
    from tokenize_audio_tpu_torch.config import UNICODE_OFFSET_LARGE

    rng = np.random.default_rng(3)
    npy_dir = os.path.join(tokdir, "_corpus")
    os.makedirs(npy_dir, exist_ok=True)
    arrays = [rng.integers(0, 2048, size=(8, 32)).astype(np.uint16) for _ in range(4)]
    obj = np.empty(len(arrays), dtype=object)
    obj[:] = arrays
    np.save(os.path.join(npy_dir, "codes_0.npy"), obj, allow_pickle=True)
    tok = CodecBPETrainer(
        8, 2048, vocab_size=8 * 2048 + 1, eos_token="<|eos|>",
        unicode_offset=UNICODE_OFFSET_LARGE,
    ).train(npy_dir)
    tok.save_pretrained(tokdir)


def build_source(src):
    """Seeded 24-group/2-file parquet tree of code-char rows (the JAX
    child's, draw for draw); idempotent."""
    import numpy as np

    from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, UNICODE_OFFSET_LARGE
    from tokenize_audio_tpu_torch.core.codes import codes_to_chars
    from tokenize_audio_tpu_torch.datasets.parquet_utils import write_parquet

    rng = np.random.default_rng(17)
    tmp = os.path.join(src.root, "tmp_build.parquet")
    for g in GROUPS:
        for fi in range(2):
            rows = []
            for i in range(40):
                codes = rng.integers(0, 2048, size=(8, int(rng.integers(10, 30))))
                text = codes_to_chars(codes, CODEBOOK_SIZE, unicode_offset=UNICODE_OFFSET_LARGE)
                rows.append({"id": f"{g}_{fi}_{i}", "text": text})
            write_parquet(rows, tmp)
            src.upload_file(tmp, f"data/{g}/f{fi}.parquet")
    os.unlink(tmp)


def main():
    srcdir, outpath, tokdir = sys.argv[1:4]
    from tokenize_audio_tpu_torch.analytics import estimate_tokens
    from tokenize_audio_tpu_torch.hub import LocalHub

    build_tokenizer(tokdir)
    build_source(LocalHub(srcdir))
    print("READY", flush=True)
    estimate_tokens.main(["--hub", f"dir:{srcdir}", "--prefix", "data/", "--tokenizer", tokdir,
                          "--sample-rows", "30", "--group-depth", "2", "--seed", "5",
                          "--output", outpath])
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
