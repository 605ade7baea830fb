"""Seeded random DAC encoder weights, made on the device in one draw.

The weights are a state dict under the names of the published
``descript/dac_44khz`` checkpoint (transformers ``DacModel``), with every
conv's weight norm as ``weight_g`` and ``weight_v``, so the program loads
them through its own checkpoint converter, which folds them, and the plain
reference folds them by its own formula. Each tensor is a slice of one
``torch.randn`` on a ``torch.Generator`` seeded from ``--seed``:

- ``weight_v`` by ``1/sqrt(fan_in)``, and the gain ``weight_g`` its
  slice's magnitude mapped into [0.75, 1.25) for the encoder's convs, so
  that a folded conv keeps its input's scale;
- the input conv at ten times that gain, so that audio at 0.3 of full
  scale becomes activations of order 3: beside them the positive offset
  each Snake adds (``sin^2 / alpha``, at most ``1 / alpha``) stays small,
  and the latent varies from frame to frame more than its mean, so every
  book spreads its codes (at unit gain the offsets made up most of the
  latent, and a book could use under 256 codes over a check's sample);
- a residual unit's k1 conv (``conv2``) at half the encoder's gain, so
  the 12 units that add into each other keep every stage's RMS of the
  same order;
- biases at 0.05 of unit scale: with unit biases the latent would be
  nearly the same vector at every frame and the codes would collapse;
- each Snake's ``alpha`` uniform in [0.5, 1.5], from its slice through the
  normal CDF (the checkpoint's values are not in the repository);
- the quantizer's projections at gain 1 and codebook entries N(0, 1).

Only the encoder's and the quantizer's tensors are made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

UNITS = 3


def _shapes(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every encoder and quantizer tensor; init is
    "fan_in", "gain", "gain_in", "gain_branch", "gain_proj", "bias",
    "alpha" or "unit"."""
    out: List[Tuple[str, tuple, str]] = []

    def conv(prefix, cout, cin, k, gain="gain"):
        out.append((f"{prefix}.weight_g", (cout, 1, 1), gain))
        out.append((f"{prefix}.weight_v", (cout, cin, k), "fan_in"))
        out.append((f"{prefix}.bias", (cout,), "bias"))

    def snake(prefix, c):
        out.append((f"{prefix}.alpha", (1, c, 1), "alpha"))

    c = cfg["encoder_hidden_size"]
    conv("encoder.conv1", c, 1, 7, "gain_in")
    for i, s in enumerate(cfg["downsampling_ratios"]):
        p = f"encoder.block.{i}"
        for j in range(1, UNITS + 1):
            snake(f"{p}.res_unit{j}.snake1", c)
            conv(f"{p}.res_unit{j}.conv1", c, c, 7)
            snake(f"{p}.res_unit{j}.snake2", c)
            conv(f"{p}.res_unit{j}.conv2", c, c, 1, "gain_branch")
        snake(f"{p}.snake1", c)
        conv(f"{p}.conv1", 2 * c, c, 2 * s)
        c *= 2
    snake("encoder.snake1", c)
    conv("encoder.conv2", cfg["hidden_size"], c, 3)
    d, v = cfg["codebook_dim"], cfg["codebook_size"]
    for k in range(cfg["n_codebooks"]):
        p = f"quantizer.quantizers.{k}"
        conv(f"{p}.in_proj", d, cfg["hidden_size"], 1, "gain_proj")
        conv(f"{p}.out_proj", cfg["hidden_size"], d, 1, "gain_proj")
        out.append((f"{p}.codebook.weight", (v, d), "unit"))
    return out


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
        elif init in ("gain", "gain_in", "gain_branch"):
            # |z| / (1 + |z|) in [0, 1): a gain in [0.75, 1.25)
            t.abs_().div_(t + 1.0).mul_(0.5).add_(0.75)
            t.mul_({"gain": 1.0, "gain_in": 10.0, "gain_branch": 0.5}[init])
        elif init == "gain_proj":
            t.fill_(1.0)
        elif init == "bias":
            t.mul_(0.05)
        elif init == "alpha":
            t.div_(math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5).add_(0.5)
        sd[name] = t
    return sd
