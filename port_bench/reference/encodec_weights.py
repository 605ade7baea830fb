"""Seeded random EnCodec encoder weights, made on the device in one draw.

The weights are a state dict under the names of the published
``facebook/encodec_24khz`` checkpoint (transformers ``EncodecModel``),
with every conv's weight norm kept as the checkpoint keeps it,
``weight_g`` and ``weight_v``, so the program loads them through its own
checkpoint converter, which folds them, and the plain reference folds
them by its own formula. Each tensor is a slice of one ``torch.randn`` on
a ``torch.Generator`` seeded from ``--seed``, scaled as
``pbkit/weights.py`` scales Mimi's: ``weight_v``, the LSTM's matrices and
every other weight by ``1/sqrt(fan_in)``, biases and codebook entries at
unit scale; a gain ``weight_g`` is its slice's magnitude plus 0.5, so the
folded weight of an output channel has a norm of 0.5 and up, near the
``1/sqrt(fan_in)`` scale per entry. Only the encoder's and the
quantizer's tensors are made.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _shapes(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every encoder and codebook tensor; init is
    "fan_in", "unit" or "gain"."""
    out: List[Tuple[str, tuple, str]] = []
    nf, ch = cfg["num_filters"], cfg["audio_channels"]

    def conv(prefix, cout, cin, k):
        out.append((f"{prefix}.weight_g", (cout, 1, 1), "gain"))
        out.append((f"{prefix}.weight_v", (cout, cin, k), "fan_in"))
        out.append((f"{prefix}.bias", (cout,), "unit"))

    conv("encoder.layers.0.conv", nf, ch, cfg["kernel_size"])
    idx, c = 1, nf
    for s in reversed(cfg["upsampling_ratios"]):
        hidden = c // cfg["compress"]
        for j in range(cfg["num_residual_layers"]):
            p = f"encoder.layers.{idx + j}"
            conv(f"{p}.block.1.conv", hidden, c, cfg["residual_kernel_size"])
            conv(f"{p}.block.3.conv", c, hidden, 1)
            if cfg["use_conv_shortcut"]:
                conv(f"{p}.shortcut.conv", c, c, 1)
        down = idx + cfg["num_residual_layers"] + 1
        conv(f"encoder.layers.{down}.conv", 2 * c, c, 2 * s)
        idx, c = down + 1, 2 * c
    for n in range(cfg["num_lstm_layers"]):
        p = f"encoder.layers.{idx}.lstm"
        out += [
            (f"{p}.weight_ih_l{n}", (4 * c, c), "fan_in"),
            (f"{p}.weight_hh_l{n}", (4 * c, c), "fan_in"),
            (f"{p}.bias_ih_l{n}", (4 * c,), "unit"),
            (f"{p}.bias_hh_l{n}", (4 * c,), "unit"),
        ]
    conv(f"encoder.layers.{idx + 2}.conv", cfg["hidden_size"], c, cfg["last_kernel_size"])
    dim = cfg.get("codebook_dim") or cfg["hidden_size"]
    for i in range(books(cfg)):
        out.append((f"quantizer.layers.{i}.codebook.embed", (cfg["codebook_size"], dim), "unit"))
    return out


def books(cfg: Dict) -> int:
    """The checkpoint's codebooks: those of its largest bandwidth."""
    hop = 1
    for r in cfg["upsampling_ratios"]:
        hop *= r
    frame_rate = -(-cfg["sampling_rate"] // hop)
    bits = (cfg["codebook_size"] - 1).bit_length()
    return int(1000 * cfg["target_bandwidths"][-1] // (frame_rate * bits))


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The encoder's and quantizer's float32 tensors under their checkpoint
    names, on ``device``, from one draw of a generator seeded with
    ``seed``."""
    specs = _shapes(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, shape, init), n in zip(specs, sizes):
        t = flat[off: off + n].view(shape)
        off += n
        if init == "fan_in":
            t.mul_(1.0 / float(torch.Size(shape[1:]).numel()) ** 0.5)
        elif init == "gain":
            t.abs_().add_(0.5)
        sd[name] = t
    return sd
