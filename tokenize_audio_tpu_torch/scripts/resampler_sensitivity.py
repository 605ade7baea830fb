"""Quantify how Mimi code output depends on the resampler's filter design.

The reference resamples with librosa/soxr_hq (librispeech-mimi/utils.py:
84-87); this framework uses a scipy.resample_poly-parity polyphase filter
(core/audio.py). librosa/soxr are not installed, so an exact
scipy-vs-librosa code delta cannot be measured here. This script measures
the next-best bound: encode the same fixtures through TWO deliberately
different high-quality designs —
  A: production filter (Kaiser beta=5.0, half-width 10, scipy default)
  B: much sharper filter (Kaiser beta=12.0, half-width 24, ~soxr_hq-class
     stopband attenuation)
and report frame exact-match between the resulting codes. If codes barely
move between two HQ filters that differ far more than scipy-vs-soxr_hq do,
the scipy-vs-librosa deviation is bounded tighter still.

The design is swapped in ``core.audio`` (``_kaiser_sinc_filter``, whose
taps only the ``_resample_plan`` cache holds) and restored, with that
cache cleared, when each encode pass ends, however it ends.

Run: python -m tokenize_audio_tpu_torch.scripts.resampler_sensitivity
     [--device cpu]   (the full-size model, random weights)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import tokenize_audio_tpu_torch.core.audio as audio_mod
from tokenize_audio_tpu_torch.config import resolve_device
from tokenize_audio_tpu_torch.core.audio import resample
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.mimi.model import encode
from tokenize_audio_tpu_torch.scripts import device_name, device_params


def make_fixtures(rng, sr, n=12, max_s=4.0):
    out = []
    for i in range(n):
        secs = 0.5 + rng.random() * (max_s - 0.5)
        t = np.arange(int(secs * sr)) / sr
        kind = i % 3
        if kind == 0:  # harmonic + vibrato
            x = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(
                2 * np.pi * 663 * t * (1 + 0.05 * np.sin(3 * t))
            )
        elif kind == 1:  # speech-ish filtered noise (high-band energy)
            x = rng.standard_normal(len(t)) * 0.3
            x = np.convolve(x, np.ones(5) / 5, mode="same") + 0.1 * rng.standard_normal(len(t))
        else:  # chirp up to near-Nyquist: max antialias stress
            f0, f1 = 100, sr * 0.45
            x = 0.3 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t**2 / (2 * t[-1])))
        out.append(x.astype(np.float32))
    return out


def with_filter(half_width, beta):
    """A polyphase design: the production filter function at another
    half-width and Kaiser beta."""
    orig = audio_mod._kaiser_sinc_filter

    def f(up, down, half_width_=half_width, beta_=beta):
        return orig(up, down, half_width=half_width_, beta=beta_)

    return f


def encode_with(params, cfg, fixtures, sr, design, device):
    """Each fixture resampled to 24 kHz through ``design`` and encoded alone
    (8 books) on ``device``; returns (codes, resampled audio). The
    production design is back in place when this returns or raises."""
    base = audio_mod._kaiser_sinc_filter
    audio_mod._kaiser_sinc_filter = design
    audio_mod._resample_plan.cache_clear()
    try:
        codes = []
        resampled = []
        for x in fixtures:
            y = resample(x, sr, 24_000, device=device).cpu().numpy()
            resampled.append(y)
            n = len(y)
            pad = -(-n // 1920) * 1920 - n
            y = np.pad(y, (0, pad))
            c, v = encode(
                params, cfg, torch.from_numpy(y[None]).to(device),
                torch.tensor([n], dtype=torch.int32, device=device), num_quantizers=8,
            )
            codes.append(c.cpu().numpy()[0, :, : int(v[0])])
        return codes, resampled
    finally:
        audio_mod._kaiser_sinc_filter = base
        audio_mod._resample_plan.cache_clear()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", device_name(dev), flush=True)
    rng = np.random.default_rng(0)
    cfg = MimiConfig()  # FULL production-size model, random weights
    params = device_params(random_params(cfg, seed=0), cfg, dev)

    design_a = with_filter(10, 5.0)  # production (scipy default)
    design_b = with_filter(24, 12.0)  # sharper, soxr_hq-class attenuation

    results = {}
    for sr in (16_000, 48_000):
        fixtures = make_fixtures(rng, sr)
        a, wav_a = encode_with(params, cfg, fixtures, sr, design_a, dev)
        b, wav_b = encode_with(params, cfg, fixtures, sr, design_b, dev)
        wav_delta = max(
            float(np.abs(x - y).max()) for x, y in zip(wav_a, wav_b)
        )
        assert wav_delta > 1e-7, "designs produced identical waveforms — experiment broken"
        print(f"  max |waveform delta| between designs: {wav_delta:.3e}")
        total = match = 0
        per_book = np.zeros(8)
        n_frames = 0
        for ca, cb in zip(a, b):
            total += ca.size
            match += (ca == cb).sum()
            per_book += (ca == cb).sum(axis=1)
            n_frames += ca.shape[1]
        frames_all_match = sum(
            ((ca == cb).all(axis=0)).sum() for ca, cb in zip(a, b)
        )
        print(
            f"{sr} Hz -> 24 kHz over {len(fixtures)} fixtures / {n_frames} frames: "
            f"code match {100.0 * match / total:.2f}%  "
            f"frame all-8-match {100.0 * frames_all_match / n_frames:.2f}%  "
            f"per-book {np.round(100 * per_book / n_frames, 2).tolist()}"
        )
        results[sr] = {
            "fixtures": len(fixtures),
            "frames": n_frames,
            "max_waveform_delta": wav_delta,
            "code_match": float(match / total),
            "frame_match": float(frames_all_match / n_frames),
            "per_book": (per_book / n_frames).tolist(),
        }
    return results


if __name__ == "__main__":
    main()
