"""High-level codec API: the one-stop equivalent of the reference's
utils helpers (librispeech-mimi/utils.py:58-87) over the port's engine.

    codec = MimiCodec.from_safetensors("model.safetensors")
    s = codec.audio_to_str(audio, sr=16_000)   # resample+encode+unicode
    wav = codec.str_to_audio(s)                # unicode -> codes -> audio

Runs on the CUDA device unless the caller passes ``device="cpu"``. A
snapshot of ``facebook/encodec_24khz`` (``model_type`` "encodec" in its
``config.json``) or of ``descript/dac_44khz`` ("dac") loads too, and
encodes through the same engine (DAC's at 44.1 kHz); neither decoder is
ported, so their codes do not decode here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import NUM_CODEBOOKS, UNICODE_OFFSET_LARGE, EngineConfig
from tokenize_audio_tpu_torch.core.codes import chars_to_codes, codes_to_chars
from tokenize_audio_tpu_torch.dac import weights as dac_weights
from tokenize_audio_tpu_torch.dac.config import DacConfig
from tokenize_audio_tpu_torch.encodec import weights as encodec_weights
from tokenize_audio_tpu_torch.encodec.config import EncodecConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.decoder import decode as mimi_decode
from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors, params_to_torch

_DECODE_KEYS = ("rvq", "upsample", "dec_tfm", "dec")


class MimiCodec:
    def __init__(
        self,
        params,
        cfg: Optional[MimiConfig | EncodecConfig | DacConfig] = None,
        engine_cfg: Optional[EngineConfig] = None,
        num_codebooks: int = NUM_CODEBOOKS,
        unicode_offset: int = UNICODE_OFFSET_LARGE,
        mesh=None,
        device: Optional[str | torch.device] = None,
    ):
        self.cfg = cfg or MimiConfig()
        self.num_codebooks = num_codebooks
        self.unicode_offset = unicode_offset
        # the engine puts a pruned encode-only subtree on the device (the
        # mesh's rank device under a mesh); the full params stay on the host
        # for the decode path, whose subtree goes to that device on the
        # first decode
        self._full_params = params
        self._decode_params = None
        self.engine = MimiEncoderEngine(
            params, self.cfg, engine_cfg, mesh=mesh, num_codebooks=num_codebooks, device=device
        )
        self.device = self.engine.device

    @classmethod
    def from_safetensors(cls, path: str, **kwargs) -> "MimiCodec":
        # the checkpoint is read with the codec's config (its layer count)
        return cls(params_from_safetensors(path, kwargs.get("cfg")), **kwargs)

    @classmethod
    def from_hf_dir(cls, snapshot_dir: str, **kwargs) -> "MimiCodec":
        """Load from a local HF snapshot directory (config.json +
        model.safetensors) — the offline equivalent of the reference's
        ``MimiModel.from_pretrained("kyutai/mimi")``
        (yodas2-mimi/process_shard.py:188-195), honoring any non-default
        checkpoint configuration. The snapshot's ``model_type`` picks the
        model: "mimi", "encodec" (``facebook/encodec_24khz``) or "dac"
        (``descript/dac_44khz``)."""
        params, cfg = read_hf_snapshot(snapshot_dir)
        return cls(params, cfg=cfg, **kwargs)

    # -- encode ------------------------------------------------------------

    def encode(self, audio: np.ndarray, sr: int = 24_000) -> np.ndarray:
        """audio -> (num_codebooks, frames) int32 codes."""
        return self.engine.encode_chunk(audio, sr=sr)

    def encode_batch(self, audios, sr: int = 24_000):
        """Many utterances -> list of (num_codebooks, frames) codes."""
        return self.engine.encode_batch(audios, sr=sr)

    def audio_to_str(self, audio: np.ndarray, sr: int = 24_000) -> str:
        codes = self.encode(audio, sr)
        return codes_to_chars(
            codes[: self.num_codebooks],
            self.cfg.codebook_size,
            unicode_offset=self.unicode_offset,
        )

    # -- decode ------------------------------------------------------------

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """(K, T) or (B, K, T) codes -> float32 audio at 24 kHz."""
        for cls, name in ((EncodecConfig, "EnCodec"), (DacConfig, "DAC")):
            if isinstance(self.cfg, cls):
                raise NotImplementedError(
                    f"{name}'s decoder is not ported: this codec encodes {name} only"
                )
        codes = np.asarray(codes)
        if codes.shape[-1] == 0:
            raise ValueError(
                "empty code stream (decoding garbage input? all characters "
                "were dropped by the validating converter)"
            )
        squeeze = codes.ndim == 2
        if squeeze:
            codes = codes[None]
        if self._decode_params is None:
            self._decode_params = params_to_torch(
                {k: self._full_params[k] for k in _DECODE_KEYS}, self.device
            )
        audio = mimi_decode(
            self._decode_params, self.cfg, torch.from_numpy(codes.astype(np.int64)).to(self.device)
        )
        audio = audio.cpu().numpy()
        return audio[0] if squeeze else audio

    def str_to_audio(self, audio_str: str) -> np.ndarray:
        codes = chars_to_codes(
            audio_str,
            self.num_codebooks,
            self.cfg.codebook_size,
            return_tensors="np",
            unicode_offset=self.unicode_offset,
        )
        return self.decode(codes)


def _config_from_json(raw: dict, cls=MimiConfig, **modes):
    """Map an HF config.json dict, and the run ``modes`` the class knows,
    onto ``cls`` (for Mimi, the subset of ``mimi.weights.config_from_hf``
    that needs no transformers import)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in {**raw, **modes}.items() if k in fields}
    if "upsampling_ratios" in kw:
        kw["upsampling_ratios"] = tuple(kw["upsampling_ratios"])
    return cls(**kw)


def read_hf_snapshot(snapshot_dir: str, **modes):
    """(params, cfg) of a local HF snapshot directory (config.json +
    model.safetensors), by its ``model_type``: "mimi" (the default),
    "encodec" or "dac". ``modes`` (``compute_dtype``, ``matmul_precision``, the
    backends) set the run modes the model's configuration has."""
    with open(os.path.join(snapshot_dir, "config.json")) as f:
        raw = json.load(f)
    weights = os.path.join(snapshot_dir, "model.safetensors")
    kind = raw.get("model_type", "mimi")
    if kind == "encodec":
        if modes.get("rvq_backend", "kernel") != "kernel":
            raise ValueError("EnCodec's RVQ runs on the kernel only (rvq_backend 'kernel')")
        cfg = _config_from_json(raw, EncodecConfig, **modes)
        return encodec_weights.params_from_safetensors(weights, cfg), cfg
    if kind == "dac":
        # DAC's encoder is plain PyTorch: the kernel backends do not apply
        cfg = _config_from_json(raw, DacConfig, **modes)
        return dac_weights.params_from_safetensors(weights, cfg), cfg
    if kind != "mimi":
        raise ValueError(
            f"{snapshot_dir}: model_type {kind!r} is not 'mimi', 'encodec' or 'dac'"
        )
    cfg = _config_from_json(raw, MimiConfig, **modes)
    return params_from_safetensors(weights, cfg), cfg
