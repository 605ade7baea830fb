"""Command-line codec: encode audio files to code strings / decode back.

    python -m tokenize_audio_tpu_torch encode --params mimi.safetensors in.wav -o out.txt
    python -m tokenize_audio_tpu_torch decode --params mimi.safetensors out.txt -o back.wav
    python -m tokenize_audio_tpu_torch info in.flac

``encode`` and ``decode`` run on the CUDA device unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tokenize_audio_tpu_torch.codec import MimiCodec
from tokenize_audio_tpu_torch.io import decode_audio, write_wav
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors, random_params


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tokenize_audio_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    device_help = "torch device (default: the CUDA device; 'cpu' runs on the CPU)"
    enc = sub.add_parser("encode", help="audio file -> unicode code string")
    enc.add_argument("inputs", nargs="+")
    enc.add_argument(
        "--params", default=None,
        help="mimi safetensors checkpoint, or a HF snapshot directory of kyutai/mimi, "
        "facebook/encodec_24khz or descript/dac_44khz (the last two encode only)",
    )
    enc.add_argument("-o", "--output", default=None, help="write codes here (default stdout)")
    enc.add_argument("--num-codebooks", type=int, default=8)
    enc.add_argument("--device", default=None, help=device_help)

    dec = sub.add_parser("decode", help="unicode code string file -> wav")
    dec.add_argument("input")
    dec.add_argument("--params", default=None)
    dec.add_argument("-o", "--output", required=True)
    dec.add_argument("--num-codebooks", type=int, default=8)
    dec.add_argument("--device", default=None, help=device_help)

    info = sub.add_parser("info", help="probe an audio container")
    info.add_argument("inputs", nargs="+")

    args = ap.parse_args(argv)

    if args.cmd == "info":
        for path in args.inputs:
            audio, sr = decode_audio(path)
            print(
                json.dumps(
                    {
                        "file": path,
                        "sample_rate": sr,
                        "samples": int(audio.shape[0]),
                        "seconds": round(audio.shape[0] / sr, 3),
                        "frames_at_12_5hz": int(-(-audio.shape[0] * 24_000 // sr // 1920)),
                    }
                )
            )
        return 0

    if args.params and os.path.isdir(args.params):
        codec = MimiCodec.from_hf_dir(
            args.params, num_codebooks=args.num_codebooks, device=args.device
        )
    else:
        cfg = MimiConfig()
        if args.params:
            params = params_from_safetensors(args.params, cfg)
        else:
            print("warning: no --params; using seeded random weights", file=sys.stderr)
            params = random_params(cfg)
        codec = MimiCodec(params, cfg, num_codebooks=args.num_codebooks, device=args.device)

    if args.cmd == "encode":
        lines = []
        for path in args.inputs:
            audio, sr = decode_audio(path)
            lines.append(codec.audio_to_str(audio, sr=sr))
        out = "\n".join(lines) + "\n"
        if args.output:
            with open(args.output, "w") as f:
                f.write(out)
        else:
            sys.stdout.write(out)
        return 0

    # decode
    with open(args.input) as f:
        s = f.read().strip()
    wav = codec.str_to_audio(s)
    write_wav(args.output, wav, 24_000)
    print(f"wrote {args.output} ({len(wav) / 24_000:.2f}s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
