"""Shared by the port's mesh tests (test_torch_parallel at 2 ranks,
test_torch_multiprocess_dp at 4): spawn a gloo world of
``torch_mesh_child.py`` ranks, compute the JAX package's references on the
same seeded inputs meanwhile, and hold the ranks' codes to them.

Codes must equal the JAX reference; a flip is allowed only in the near-tie
class (PARITY.md:66-82): at most one flipped frame across a check's inputs,
at a relative argmin margin under 1e-7, replayed here on the port's plain
one-shot RVQ input of that utterance."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import torch_mesh_child as child

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "torch_mesh_child.py"
RANK_WALL_SECONDS = 300  # each rank's limit: a fault ends in a failure, never a stall
TIE_MARGIN = 1e-7


class World:
    def __init__(self, n, out):
        self.n, self.out = n, out
        self.info = [json.loads((out / f"r{r}.json").read_text()) for r in range(n)]
        self.arrays = [np.load(out / f"r{r}.npz") for r in range(n)]

    def codes(self, rank, name):
        return [self.arrays[rank][f"{name}_{i}"] for i in range(self.info[rank][f"{name}_n"])]


def start_world(n, out):
    """Start the n ranks; returns a function that waits for them (each
    within RANK_WALL_SECONDS, else all are killed) and returns the World,
    failing with the log of any rank that failed."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(ROOT)
    procs = [
        subprocess.Popen(
            [sys.executable, str(CHILD), "--rank", str(r), "--world", str(n),
             "--store", str(out / "store"), "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(n)
    ]

    def finish():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_WALL_SECONDS)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            logs += [p.communicate()[0] for p in procs[len(logs):]]
            raise AssertionError(f"a rank ran past {RANK_WALL_SECONDS} s:\n" + _tails(logs))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        assert not bad, f"ranks {bad} failed:\n" + _tails(logs)
        return World(n, out)

    return finish


def _tails(logs):
    return "\n".join(f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs))


def jax_references():
    """The JAX package's codes of every input: the solo engine's (the
    child's ENGINE config) and the replicated ``encode`` of the two raw
    batches."""
    import jax.numpy as jnp

    from tokenize_audio_tpu.config import EngineConfig
    from tokenize_audio_tpu.engine import MimiEncoderEngine
    from tokenize_audio_tpu.mimi import MimiConfig
    from tokenize_audio_tpu.mimi.model import encode
    from tokenize_audio_tpu.mimi.weights import random_params

    cfg = MimiConfig(**child.TINY)
    params = random_params(cfg, seed=0)
    x = child.inputs()
    solo = MimiEncoderEngine(params, cfg, EngineConfig(**child.ENGINE))
    ref24 = solo.encode_batch(x["audios24"] + x["warm"][:2])
    raw, _ = encode(params, cfg, jnp.asarray(x["full"]), jnp.asarray(x["valid"]))
    tp, _ = encode(params, cfg, jnp.asarray(x["tp_audio"]), jnp.asarray(x["tp_valid"]))
    raw = np.asarray(raw)
    return {
        "params": params,
        "audios24": ref24[:8],
        "warm": ref24[8:] * 4,
        "pcm16": solo.encode_batch(x["pcm16"], sr=16_000),
        "raw": raw,
        "raw_rows": [raw[i, :, : -(-int(v) // child.SPF)] for i, v in enumerate(x["valid"])],
        "tp": np.asarray(tp),
    }


def flip_margin(params, audio, sr, frame, got, want):
    """The relative margin at ``frame``'s first differing book, replayed on
    the port's plain one-shot RVQ input of ``audio``."""
    import torch
    import torch.nn.functional as F

    from tokenize_audio_tpu_torch.mimi import MimiConfig, model, params_to_torch
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    cfg = MimiConfig(**child.TINY)
    tparams = params_to_torch(params, "cpu")
    g = math.gcd(sr, 24_000)
    up, down = 24_000 // g, sr // g
    spf_io = child.SPF * down // up
    padded = np.zeros(-(-len(audio) // spf_io) * spf_io, dtype=audio.dtype)
    padded[: len(audio)] = audio
    seen, orig = {}, model.split_rvq_encode

    def spy(p, emb, *args, **kwargs):
        seen["emb"] = emb
        return orig(p, emb, *args, **kwargs)

    model.split_rvq_encode = spy
    try:
        model.encode(tparams, cfg, torch.from_numpy(padded)[None],
                     torch.tensor([len(audio)], dtype=torch.int32), num_quantizers=got.shape[0],
                     resample=None if sr == 24_000 else (up, down))
    finally:
        model.split_rvq_encode = orig
    margins = []
    for head, lo, hi in (("semantic", 0, 1), ("acoustic", 1, got.shape[0])):
        g_, w_ = (torch.from_numpy(np.ascontiguousarray(c[lo:hi, frame : frame + 1].T))
                  for c in (got, want))
        if hi <= lo or bool((g_ == w_).all()):
            continue
        p = tparams["rvq"][head]
        xin = F.conv1d(seen["emb"][:, :, frame : frame + 1], p["in_proj"][:, :, None])
        margins += rvq.first_divergence_margins(
            xin[0].T.contiguous(), p["embed"][: hi - lo], g_, w_)[1]
    return max(margins, key=abs)


def assert_codes_match(got, want, audios=None, sr=24_000, params=None):
    """Equal code lists, but for at most one flipped frame, a near-tie."""
    assert len(got) == len(want)
    flips = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        flips += [(i, int(f)) for f in np.nonzero((g != w).any(axis=0))[0]]
    assert len(flips) <= 1, f"{len(flips)} flipped frames — beyond near-tie territory"
    for i, f in flips:
        assert audios is not None, f"utterance {i} frame {f} flipped"
        m = flip_margin(params, audios[i], sr, f, got[i], want[i])
        assert abs(m) < TIE_MARGIN, f"utterance {i} frame {f}: margin {m} is no near-tie"


def check_meshes(world):
    n = world.n
    for r, info in enumerate(world.info):
        m = info["meshes"]
        assert m["dp"]["shape"] == {"data": n, "model": 1}
        assert (m["dp"]["data_index"], m["dp"]["model_index"]) == (r, 0)
        assert m["dp"]["data_group"] == list(range(n)) and m["dp"]["model_group"] == [r]
        assert m["span"]["shape"] == {"data": 1, "model": n}
        assert (m["span"]["data_index"], m["span"]["model_index"]) == (0, r)
        assert m["span"]["model_group"] == list(range(n)) and m["span"]["data_group"] == [r]
        if "grid" in m:  # rank = d * tp + m, row-major as JAX's reshape(dp, tp)
            g = m["grid"]
            assert g["shape"] == {"data": n // 2, "model": 2}
            assert (g["data_index"], g["model_index"]) == divmod(r, 2)
            assert g["model_group"] == [r - r % 2, r - r % 2 + 1]
            assert g["data_group"] == list(range(r % 2, n, 2))
        assert all(x["world_size"] == n and x["backend"] == "gloo" for x in m.values())


def check_tp_encode(world, refs):
    full = refs["params"]["tfm"][0]
    names = [n for n in ("span", "grid") if f"tp_{n}_codes" in world.arrays[0]]
    for name in names:
        codes = {}
        for r in range(world.n):
            mesh = world.info[r]["meshes"][name]
            tp, m = mesh["shape"]["model"], mesh["model_index"]
            a = world.arrays[r]
            for k in ("q", "k", "v", "fc1"):
                blk = full[k].shape[0] // tp
                np.testing.assert_array_equal(a[f"tp_{name}_slice_{k}"],
                                              full[k][m * blk : (m + 1) * blk])
            for k in ("o", "fc2"):
                blk = full[k].shape[1] // tp
                np.testing.assert_array_equal(a[f"tp_{name}_slice_{k}"],
                                              full[k][:, m * blk : (m + 1) * blk])
            # the row-parallel sum adds partial products in another order
            assert world.info[r][f"tp_{name}_tfm_max_abs"] <= 1e-5
            codes.setdefault(tuple(world.info[r][f"tp_{name}_rows"]), []).append(a[f"tp_{name}_codes"])
        got = np.concatenate([v[0] for _, v in sorted(codes.items())])
        for _, replicas in codes.items():  # ranks of one data block agree
            for c in replicas[1:]:
                np.testing.assert_array_equal(c, replicas[0])
        assert_codes_match(list(got), list(refs["tp"]))


def check_engines(world, refs, name, want, inputs, sr=24_000):
    for r in range(world.n):  # every rank returns the full list
        assert_codes_match(world.codes(r, name), want, inputs, sr, refs["params"])


def check_helpers(world, refs):
    spans = [tuple(world.info[r]["helpers_span"]) for r in range(world.n)]
    per = len(refs["raw"]) // world.n
    assert spans == [(r * per, (r + 1) * per) for r in range(world.n)]
    got = np.concatenate([world.arrays[r]["helpers"] for r in range(world.n)])
    assert got.shape == refs["raw"].shape
    assert_codes_match(list(got), list(refs["raw"]))


def check_refusals(world):
    for info in world.info:
        r = info["refusals"]
        assert r["batch_divisibility"][0] == "ValueError" and "divide evenly" in r["batch_divisibility"][1]
        assert r["compact"][0] == "ValueError" and "single-device" in r["compact"][1]
        assert r["not_a_mesh"][0] == "TypeError"
        for k in ("autotune_transfer", "autotune_pipeline_depth", "autotune_drain_policy",
                  "request_autotune"):
            assert r[k][0] == "RuntimeError" and "multiprocess" in r[k][1], r[k]
        assert r["oversized_mesh"][0] == "ValueError" and "needs" in r["oversized_mesh"][1]
        assert r["process_span"][0] == "ValueError" and "evenly" in r["process_span"][1]
