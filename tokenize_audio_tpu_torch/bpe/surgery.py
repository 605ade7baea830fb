"""Tokenizer surgery utilities.

Capability equivalent of the reference's ``codec-bpe/qwen3x.ipynb``: rename
an existing special token in place (keeping its id — e.g. ``<|endoftext|>``
-> ``<|end_of_text|>`` at id 151643), add a BOS token, resize the model's
token embeddings to the extended vocab (the notebook's final step — the
one that makes the audio-extended tokenizer usable for pretraining), and
sanity-check the result. Works on any ``PreTrainedTokenizerFast`` saved
directory / ``PreTrainedModel``.

The port's copy of the JAX package's module of the same path. Its command
line also takes ``--device``: the model given by ``--model`` is loaded onto
the CUDA device unless another (``--device cpu``) is named, and asking for
CUDA where there is none raises. The new rows' noise is drawn from a CPU
generator either way, so the device changes only the mean's reduction order.

    python -m tokenize_audio_tpu_torch.bpe.surgery --tokenizer base/ \
        --out-dir ext/ --add-audio-alphabet --pipeline-specials \
        --model lm/ --model-out lm_ext/ [--device cpu]
"""

from __future__ import annotations

import json
import os
import shutil


def rename_token_in_place(tokenizer_dir: str, old: str, new: str, out_dir: str) -> None:
    """Copy a fast-tokenizer directory, renaming ``old`` -> ``new`` in the
    vocab (id preserved) and in every special-token config reference.
    ``out_dir`` may equal ``tokenizer_dir`` (chained renames edit in place)."""
    os.makedirs(out_dir, exist_ok=True)
    if os.path.abspath(tokenizer_dir) != os.path.abspath(out_dir):
        for f in os.listdir(tokenizer_dir):
            src = os.path.join(tokenizer_dir, f)
            if os.path.isfile(src):
                shutil.copyfile(src, os.path.join(out_dir, f))

    tok_json = os.path.join(out_dir, "tokenizer.json")
    with open(tok_json) as f:
        data = json.load(f)
    vocab = data["model"]["vocab"]
    if old not in vocab:
        raise KeyError(f"token {old!r} not in vocab")
    if new in vocab:
        raise ValueError(f"token {new!r} already in vocab")
    vocab[new] = vocab.pop(old)
    for added in data.get("added_tokens", []):
        if added.get("content") == old:
            added["content"] = new
    with open(tok_json, "w") as f:
        json.dump(data, f, ensure_ascii=False)

    for cfg_name in ("tokenizer_config.json", "special_tokens_map.json"):
        path = os.path.join(out_dir, cfg_name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            cfg = json.load(f)

        def _sub(x):
            if isinstance(x, str):
                return new if x == old else x
            if isinstance(x, dict):
                return {k: _sub(v) for k, v in x.items()}
            if isinstance(x, list):
                return [_sub(v) for v in x]
            return x

        with open(path, "w") as f:
            json.dump(_sub(cfg), f, ensure_ascii=False)


def extend_model_embeddings(
    model,
    new_vocab_size: int,
    num_tokens_to_copy: int | None = None,
    noise_std: float = 0.02,
    seed: int = 0,
):
    """Resize a causal LM's token embeddings to an extended vocabulary.

    The final step of the reference's tokenizer-surgery recipe
    (``codec-bpe/qwen3x.ipynb``, "extend the current embedding ... from
    151936 to 168059"): rows ``[0, num_tokens_to_copy)`` keep their trained
    values; every new row is initialized to the mean of the copied rows
    plus small Gaussian noise (std ``noise_std``), in the model's own
    dtype. An untied ``lm_head`` is extended the same way; tied weights
    follow the embedding automatically.

    ``num_tokens_to_copy`` defaults to the current embedding size; pass a
    smaller value to drop trailing distributed-training padding rows (the
    notebook copies only 151669 of Qwen3's 151936 padded rows). Returns the
    model (modified in place).
    """
    import torch

    embed = model.get_input_embeddings()
    old = embed.weight.data
    n_copy = old.shape[0] if num_tokens_to_copy is None else num_tokens_to_copy
    if n_copy > old.shape[0]:
        raise ValueError(
            f"num_tokens_to_copy {n_copy} exceeds current vocab {old.shape[0]}"
        )
    if new_vocab_size < n_copy:
        raise ValueError(
            f"new_vocab_size {new_vocab_size} smaller than rows to copy {n_copy}"
        )
    gen = torch.Generator().manual_seed(seed)

    def _extend(w: torch.Tensor) -> torch.Tensor:
        kept = w[:n_copy]
        # mean in f32 (a bf16 accumulation over 150k rows loses ~3 digits),
        # on CPU: `gen` is a CPU generator, so build the new rows there and
        # move once — mixing a CUDA-resident mean with CPU noise would crash
        mean = kept.float().mean(dim=0).cpu()
        noise = torch.randn(
            (new_vocab_size - n_copy, w.shape[1]), generator=gen, dtype=torch.float32
        ) * noise_std
        new_rows = (mean[None, :] + noise).to(dtype=w.dtype, device=w.device)
        return torch.cat([kept, new_rows], dim=0)

    tied = getattr(model.config, "tie_word_embeddings", False)
    new_embed = torch.nn.Embedding(
        new_vocab_size, old.shape[1], dtype=old.dtype, device=old.device
    )
    with torch.no_grad():
        new_embed.weight.copy_(_extend(old))
    model.set_input_embeddings(new_embed)

    head = model.get_output_embeddings()
    if head is not None:
        if tied:
            model.tie_weights()  # re-point the head at the new embedding
        else:
            new_head = torch.nn.Linear(
                head.in_features,
                new_vocab_size,
                bias=head.bias is not None,
                dtype=head.weight.dtype,
                device=head.weight.device,
            )
            with torch.no_grad():
                new_head.weight.copy_(_extend(head.weight.data))
                if head.bias is not None:
                    new_head.bias.zero_()
                    new_head.bias[:n_copy].copy_(head.bias.data[:n_copy])
            model.set_output_embeddings(new_head)
    model.config.vocab_size = new_vocab_size
    model.vocab_size = new_vocab_size
    return model


def set_bos_token(tokenizer_dir: str, bos: str, add_if_missing: bool = True):
    """Load, optionally add, and register a BOS token; returns the tokenizer."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_dir)
    if bos not in tok.get_vocab() and add_if_missing:
        tok.add_special_tokens({"bos_token": bos})
    else:
        tok.bos_token = bos
    return tok


def main(argv=None):
    """The qwen3x.ipynb recipe as one command: rename special tokens in
    place (id-preserving), register a BOS, add the audio code alphabet +
    pipeline specials, save the extended tokenizer, and (optionally)
    resize a causal LM's embeddings to the final vocab."""
    import argparse

    from tokenize_audio_tpu_torch.config import (
        CODEBOOK_SIZE,
        NUM_CODEBOOKS,
        SPECIAL_TOKENS,
        UNICODE_OFFSET_LARGE,
        resolve_device,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tokenizer", required=True, help="base fast-tokenizer dir")
    ap.add_argument("--out-dir", required=True, help="extended tokenizer output dir")
    ap.add_argument(
        "--rename",
        action="append",
        default=[],
        metavar="OLD=NEW",
        help="id-preserving special-token rename; repeatable "
        "(qwen3x: '<|endoftext|>=<|end_of_text|>')",
    )
    ap.add_argument("--bos", help="BOS token to add/register (qwen3x: '<|begin_of_text|>')")
    ap.add_argument(
        "--add-audio-alphabet",
        action="store_true",
        help="add the num_codebooks x codebook_size code chars "
        "(train_bpe_recipe.txt step 3)",
    )
    ap.add_argument("--num-codebooks", type=int, default=NUM_CODEBOOKS)
    ap.add_argument("--codebook-size", type=int, default=CODEBOOK_SIZE)
    ap.add_argument(
        "--unicode-offset", type=lambda s: int(s, 0), default=UNICODE_OFFSET_LARGE
    )
    ap.add_argument(
        "--pipeline-specials",
        action="store_true",
        help="also add the pipeline special tokens "
        "(<|text_start|> <|text_end|> <|audio_start|> <|audio_end|>)",
    )
    ap.add_argument(
        "--special-tokens", default="", help="extra comma-separated special tokens"
    )
    ap.add_argument("--model", help="HF causal-LM dir to resize to the final vocab")
    ap.add_argument("--model-out", help="resized model output dir (default <model>_extended)")
    ap.add_argument(
        "--num-tokens-to-copy",
        type=int,
        help="embedding rows to keep from the base model; rows past this are "
        "re-initialized (mean+noise) — set it to the base TOKENIZER's vocab "
        "size when the model carries trailing distributed-training padding "
        "rows (qwen3x copies 151669 of Qwen3's 151936), else new tokens "
        "silently inherit stale padding embeddings",
    )
    ap.add_argument(
        "--device",
        help="where --model is resized: the CUDA device unless another "
        "(e.g. 'cpu') is named",
    )
    args = ap.parse_args(argv)
    # resolved before anything is written: CUDA asked for where there is
    # none raises here, not after the tokenizer is saved
    device = resolve_device(args.device) if args.model else None

    renames = []
    for spec in args.rename:
        old, eq, new = spec.partition("=")
        if not eq or not old or not new:
            # validate EVERY spec before performing ANY rename — erroring
            # out mid-loop would leave a half-renamed tokenizer in out_dir
            # that looks complete to a later pipeline step
            ap.error(f"--rename expects OLD=NEW, got {spec!r}")
        renames.append((old, new))
    src = args.tokenizer
    for old, new in renames:
        rename_token_in_place(src, old, new, args.out_dir)
        src = args.out_dir
    if args.bos:
        tok = set_bos_token(src, args.bos)
    else:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(src)
    if args.add_audio_alphabet or args.pipeline_specials or args.special_tokens:
        from tokenize_audio_tpu_torch.bpe.trainer import extend_tokenizer

        specials = [t for t in args.special_tokens.split(",") if t]
        if args.pipeline_specials:
            specials = [
                SPECIAL_TOKENS[k]
                for k in ("text_start", "text_end", "audio_start", "audio_end")
            ] + specials
        tok = extend_tokenizer(
            tok,
            args.num_codebooks if args.add_audio_alphabet else 0,
            args.codebook_size,
            args.unicode_offset,
            specials,
        )
    tok.save_pretrained(args.out_dir)
    report = {"tokenizer_out": args.out_dir, "vocab_size": len(tok)}
    if args.model:
        from transformers import AutoModelForCausalLM

        model = AutoModelForCausalLM.from_pretrained(args.model).to(device)
        extend_model_embeddings(model, len(tok), num_tokens_to_copy=args.num_tokens_to_copy)
        model_out = args.model_out or (args.model.rstrip("/") + "_extended")
        model.save_pretrained(model_out)
        report["model_out"] = model_out
        report["model_vocab_size"] = int(model.config.vocab_size)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
