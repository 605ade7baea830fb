"""Codec-BPE tokenizer training over unicode code streams.

Capability equivalent of ``codec-bpe/bpe_trainer.py`` (which itself replaces
the external ``codec_bpe`` package's trainer, per
``codec-bpe/train_bpe_recipe.txt:12``):

  - the initial alphabet is exactly the ``num_codebooks x codebook_size``
    code characters, so a codeword is never split (:115-120);
  - ``max_token_codebook_ngrams`` bounds merged tokens to n whole frames
    (token length <= n * num_codebooks chars, :122-128; the +1 accounts for
    the tokenizers library treating max_token_length as exclusive);
  - long streams are chunked to ``chunk_size_secs * framerate`` frames
    before feeding the trainer (:96-105);
  - the result wraps into a ``transformers.PreTrainedTokenizerFast``
    (:157-165).

Built directly on the HF ``tokenizers`` (Rust) BPE trainer; code streams
contain no whitespace, so no pre-tokenizer is needed. The port's copy of the
JAX package's module of the same path; host code, no device work.
``tokenizers`` and ``transformers`` are imported where they are used.

    python -m tokenize_audio_tpu_torch.bpe.trainer --codes-dir /data/npys \
        --out-dir /data/tok [--vocab-size 30000] [--max-token-codebook-ngrams 0]
"""

from __future__ import annotations

import glob
import inspect
import os
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from tokenize_audio_tpu_torch.config import FRAME_RATE, UNICODE_OFFSET
from tokenize_audio_tpu_torch.core.codes import codes_to_chars, validate_unicode_offset


def load_codes_file(path: str) -> List[np.ndarray]:
    """Load a sampler .npy: either an object array/list of (K,T) arrays (the
    consolidated sampler format) or a single (K,T) array; (1,K,T)/(1,1,K,T)
    shapes are squeezed (bpe_trainer.py:73-95)."""
    data = np.load(path, allow_pickle=True)
    if isinstance(data, np.ndarray) and data.dtype == object and data.ndim == 0:
        items = data.item()
        if not isinstance(items, list):
            items = [items]
    elif isinstance(data, np.ndarray) and data.dtype == object and data.ndim == 1:
        items = list(data)
    else:
        items = [data]
    out = []
    for codes in items:
        codes = np.asarray(codes)
        if codes.ndim == 4:
            codes = codes[0, 0]
        elif codes.ndim == 3:
            codes = codes[0]
        out.append(codes)
    return out


class CodecBPETrainer:
    def __init__(
        self,
        num_codebooks: int,
        codebook_size: int,
        codec_framerate: Optional[float] = FRAME_RATE,
        chunk_size_secs: Optional[int] = None,
        vocab_size: int = 30_000,
        min_frequency: int = 2,
        special_tokens: Optional[Sequence[str]] = None,
        bos_token: Optional[str] = None,
        eos_token: Optional[str] = None,
        unk_token: Optional[str] = None,
        pad_token: Optional[str] = None,
        max_token_codebook_ngrams: Optional[int] = None,
        unicode_offset: int = UNICODE_OFFSET,
    ):
        if chunk_size_secs is not None and codec_framerate is None:
            raise ValueError("chunk_size_secs requires codec_framerate")
        if eos_token is None and pad_token is None:
            raise ValueError("set eos_token or pad_token so padded batching works")
        if max_token_codebook_ngrams is not None and max_token_codebook_ngrams < 0:
            raise ValueError("max_token_codebook_ngrams must be >= 0")
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        self.codec_framerate = codec_framerate
        self.chunk_size_secs = chunk_size_secs
        self.vocab_size = vocab_size
        self.min_frequency = min_frequency
        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token, self.pad_token = unk_token, pad_token
        self.max_token_codebook_ngrams = max_token_codebook_ngrams
        self.unicode_offset = validate_unicode_offset(
            unicode_offset, num_codebooks, codebook_size
        )
        self.special_tokens = list(special_tokens or [])
        for t in (eos_token, bos_token, unk_token, pad_token):
            if t is not None and t not in self.special_tokens:
                self.special_tokens.insert(0, t)
        min_vocab = num_codebooks * codebook_size + len(self.special_tokens)
        if vocab_size < min_vocab:
            raise ValueError(
                f"vocab_size {vocab_size} < minimum {min_vocab} "
                f"({num_codebooks}x{codebook_size} codes + "
                f"{len(self.special_tokens)} specials)"
            )

    @property
    def initial_alphabet(self) -> List[str]:
        lo = self.unicode_offset
        return [chr(i) for i in range(lo, lo + self.num_codebooks * self.codebook_size)]

    def iterate_streams(self, codes_files: Sequence[str]) -> Iterator[str]:
        chunk_frames = (
            int(self.chunk_size_secs * self.codec_framerate)
            if self.chunk_size_secs
            else None
        )
        for path in codes_files:
            for codes in load_codes_file(path):
                codes = codes[: self.num_codebooks]
                step = chunk_frames or codes.shape[1]
                for i in range(0, codes.shape[1], max(step, 1)):
                    yield codes_to_chars(
                        codes[:, i : i + step],
                        self.codebook_size,
                        unicode_offset=self.unicode_offset,
                    )

    def train(
        self,
        codes_path: str,
        codes_filter: Optional[Union[str, List[str]]] = None,
        num_files: Optional[int] = None,
    ):
        from tokenizers import Tokenizer
        from tokenizers.models import BPE
        from tokenizers.trainers import BpeTrainer
        from transformers import PreTrainedTokenizerFast

        max_token_length = None
        if self.max_token_codebook_ngrams is not None:
            max_token_length = max(1, self.max_token_codebook_ngrams * self.num_codebooks)

        if max_token_length == 1:
            iterator: Iterator[str] = iter(())  # alphabet-only vocab, no merges
        else:
            files = sorted(glob.glob(os.path.join(codes_path, "**", "*.npy"), recursive=True))
            if codes_filter:
                filters = [codes_filter] if isinstance(codes_filter, str) else codes_filter
                files = [f for f in files if any(flt in f for flt in filters)]
            if num_files:
                files = files[:num_files]
            if not files:
                raise FileNotFoundError(f"no .npy code files under {codes_path}")
            iterator = self.iterate_streams(files)
            if max_token_length is not None:
                max_token_length += 1  # tokenizers treats the bound as exclusive

        from tokenizers import decoders

        tokenizer = Tokenizer(BPE(unk_token=self.unk_token))
        # decode must concatenate code chars without separators (the
        # reference's Metaspace decoder is a no-op on code streams)
        tokenizer.decoder = decoders.Fuse()
        trainer = BpeTrainer(
            vocab_size=self.vocab_size,
            min_frequency=self.min_frequency,
            special_tokens=self.special_tokens,
            initial_alphabet=self.initial_alphabet,
            limit_alphabet=len(self.initial_alphabet),
            **({"max_token_length": max_token_length} if max_token_length else {}),
        )
        tokenizer.train_from_iterator(iterator, trainer=trainer)
        return PreTrainedTokenizerFast(
            tokenizer_object=tokenizer,
            bos_token=self.bos_token,
            eos_token=self.eos_token,
            unk_token=self.unk_token,
            pad_token=self.pad_token,
            clean_up_tokenization_spaces=False,
            model_input_names=["input_ids", "attention_mask"],
        )


def extend_tokenizer(
    base,
    num_codebooks: int,
    codebook_size: int,
    unicode_offset: int,
    special_tokens: Sequence[str] = (),
):
    """Extend an existing text tokenizer with the audio code alphabet and
    pipeline special tokens (train_bpe_recipe.txt:33-93 recipe step 3).

    ``base``: a transformers tokenizer instance or name/path loadable by
    AutoTokenizer. Returns the extended tokenizer.
    """
    if isinstance(base, str):
        from transformers import AutoTokenizer

        base = AutoTokenizer.from_pretrained(base)
    alphabet = [
        chr(i)
        for i in range(unicode_offset, unicode_offset + num_codebooks * codebook_size)
    ]
    base.add_tokens(alphabet)
    if special_tokens:
        # extend the tokenizer's extra specials, never replace them: the
        # keyword is replace_additional_special_tokens in transformers 4 and
        # replace_extra_special_tokens in 5 (which maps the
        # "additional_special_tokens" key onto its extra_special_tokens)
        params = inspect.signature(base.add_special_tokens).parameters
        keyword = (
            "replace_extra_special_tokens"
            if "replace_extra_special_tokens" in params
            else "replace_additional_special_tokens"
        )
        base.add_special_tokens(
            {"additional_special_tokens": list(special_tokens)}, **{keyword: False}
        )
    return base


def main(argv=None):
    """Train a codec-BPE tokenizer from sampled .npy code files — the
    train_bpe_recipe.txt 16k/128k recipes as one command. ``--extend-base``
    instead extends an existing text tokenizer with the audio alphabet
    (recipe step 3)."""
    import argparse
    import json

    from tokenize_audio_tpu_torch.config import SPECIAL_TOKENS

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--codes-dir", help=".npy corpus dir (from bpe.sampler)")
    ap.add_argument("--out-dir", required=True, help="tokenizer output dir")
    ap.add_argument("--num-codebooks", type=int, default=8)
    ap.add_argument("--codebook-size", type=int, default=2048)
    ap.add_argument("--vocab-size", type=int, default=30_000)
    ap.add_argument("--min-frequency", type=int, default=2)
    ap.add_argument(
        "--max-token-codebook-ngrams",
        type=int,
        help="bound merges to n full frames; 0 = alphabet-only (the 16k "
        "no-merge recipe)",
    )
    ap.add_argument("--chunk-size-secs", type=int, help="split long streams for training")
    ap.add_argument("--unicode-offset", type=lambda s: int(s, 0), default=UNICODE_OFFSET)
    ap.add_argument("--eos-token", default=SPECIAL_TOKENS["eos"])
    ap.add_argument("--bos-token")
    ap.add_argument("--unk-token")
    ap.add_argument("--pad-token")
    ap.add_argument("--num-files", type=int, help="train on only the first N files")
    ap.add_argument(
        "--extend-base",
        help="extend this existing tokenizer (name/path) with the audio "
        "alphabet instead of training from scratch",
    )
    ap.add_argument(
        "--pipeline-specials",
        action="store_true",
        help="add <|text_start|> <|text_end|> <|audio_start|> <|audio_end|>",
    )
    args = ap.parse_args(argv)

    specials = (
        [SPECIAL_TOKENS[k] for k in ("text_start", "text_end", "audio_start", "audio_end")]
        if args.pipeline_specials
        else []
    )
    if args.extend_base:
        tok = extend_tokenizer(
            args.extend_base,
            args.num_codebooks,
            args.codebook_size,
            args.unicode_offset,
            specials,
        )
    else:
        if not args.codes_dir:
            ap.error("--codes-dir is required unless --extend-base is given")
        tok = CodecBPETrainer(
            args.num_codebooks,
            args.codebook_size,
            chunk_size_secs=args.chunk_size_secs,
            vocab_size=args.vocab_size,
            min_frequency=args.min_frequency,
            special_tokens=specials,
            bos_token=args.bos_token,
            eos_token=args.eos_token,
            unk_token=args.unk_token,
            pad_token=args.pad_token,
            max_token_codebook_ngrams=args.max_token_codebook_ngrams,
            unicode_offset=args.unicode_offset,
        ).train(args.codes_dir, num_files=args.num_files)
    tok.save_pretrained(args.out_dir)
    print(json.dumps({"tokenizer_out": args.out_dir, "vocab_size": len(tok)}))


if __name__ == "__main__":
    main()
