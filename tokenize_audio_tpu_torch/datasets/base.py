"""Pretraining document templates shared by every dataset builder.

Formats match the reference exactly:
  - type1 (text -> audio, "TTS direction"):
      <|begin_of_text|><|text_start|>t<|text_end|><|audio_start|>a<|audio_end|>...<|end_of_text|>
    (pretraining-data/prepare_pretraining_data.py:273-291,
     librispeech-mimi/process_librispeech_train.py:197)
  - type2 (audio -> text, "ASR direction"): the reverse per chunk
    (prepare_pretraining_data.py:293-311, process_librispeech_train.py:196)
  - tts0 / conversational: a speaker tag "[n]" immediately after each
    <|text_start|> (mls-en-mimi-pretrain/build_mls_en_mm_tts0.py:104-116,
     emilia-mimi/process_shard_conversational.py:556-584)
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from tokenize_audio_tpu_torch.config import SPECIAL_TOKENS as T


def _speaker(tag: Optional[int]) -> str:
    return f"[{tag}]" if tag is not None else ""


def interleaved_type1(
    chunks: Iterable[Tuple[str, str]], speaker_tags: Optional[Sequence[Optional[int]]] = None
) -> str:
    """text->audio interleaved document over (text, audio_str) chunks."""
    parts: List[str] = [T["bos"]]
    tags = list(speaker_tags) if speaker_tags is not None else None
    for i, (text, audio_str) in enumerate(chunks):
        tag = _speaker(tags[i]) if tags is not None else ""
        parts += [T["text_start"], tag, text, T["text_end"]]
        parts += [T["audio_start"], audio_str, T["audio_end"]]
    parts.append(T["eos"])
    return "".join(parts)


def interleaved_type2(
    chunks: Iterable[Tuple[str, str]], speaker_tags: Optional[Sequence[Optional[int]]] = None
) -> str:
    """audio->text interleaved document over (text, audio_str) chunks."""
    parts: List[str] = [T["bos"]]
    tags = list(speaker_tags) if speaker_tags is not None else None
    for i, (text, audio_str) in enumerate(chunks):
        tag = _speaker(tags[i]) if tags is not None else ""
        parts += [T["audio_start"], audio_str, T["audio_end"]]
        parts += [T["text_start"], tag, text, T["text_end"]]
    parts.append(T["eos"])
    return "".join(parts)


def tts_document(text: str, audio_str: str, speaker_tag: Optional[int] = None) -> str:
    """Single-chunk type1 row (_type1 suffix in parquet outputs)."""
    return interleaved_type1([(text, audio_str)], [speaker_tag] if speaker_tag is not None else None)


def asr_document(text: str, audio_str: str) -> str:
    """Single-chunk type2 row (_type2 suffix in parquet outputs)."""
    return interleaved_type2([(text, audio_str)])


def speaker_tagged_text(text: str, speaker: int) -> str:
    """'[n]text' body used by tts0/conversational variants."""
    return f"[{speaker}]{text}"
