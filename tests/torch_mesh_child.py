"""One rank of a CPU world for the port's mesh tests (test_torch_parallel,
test_torch_multiprocess_dp). Imports no JAX.

Each rank joins a gloo world through a FileStore, builds the same meshes
as its peers, and runs on the tiny config (params from the port's
``random_params``, the JAX package's draws):

  1. mesh shapes and indices: the dp mesh (world x 1), the tp-spanning mesh
     (1 x world) and, at 4 ranks, the 2 x 2 grid;
  2. tensor-parallel encode on the tp-spanning mesh (and the grid): this
     rank's ``shard_params_tp`` slices, its codes of its data block, and the
     transformer's output against the replicated run;
  3. the engine over the dp mesh (24 kHz, fused 16 kHz, padded and packed,
     warmup, stream policy), over the grid, and over the tp-spanning mesh
     on an odd 3-utterance list;
  4. the helpers path: process_span -> host_local_to_global -> encode ->
     local_rows;
  5. the refusals, each recorded as (exception type, message).

Results go to --out as ``r{rank}.npz`` and ``r{rank}.json`` for the test to
hold against the JAX package. Run only via the tests.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SPF = 1920
TINY = dict(
    num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
    num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
    codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
    upsample_groups=32,
)
ENGINE = dict(batch_size=8, min_bucket_seconds=0.5, max_chunk_seconds=4.0)


def inputs():
    """Every input of the world, from numpy seeds (the parent draws the same)."""
    rng = np.random.default_rng(20260818)
    audios24 = [(rng.standard_normal(n) * 0.3).astype(np.float32)
                for n in (1000, 5000, 9000, 20000, 1920, 333, 48000, 2500)]
    pcm16 = [(rng.standard_normal(n) * 8000).astype(np.int16)
             for n in (1000, 4801, 12_000, 2560, 640, 9000, 3000, 7000)]
    warm = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (1000, 20000)] * 4
    rng = np.random.default_rng(7)
    t = 4 * SPF
    full = (rng.standard_normal((8, t)) * 0.3).astype(np.float32)
    valid = np.array([t, 100, 2 * SPF, 3 * SPF - 5, t, SPF, 2000, t - 1], dtype=np.int32)
    rng = np.random.default_rng(27)
    tp_audio = (rng.standard_normal((2, 2 * SPF)) * 0.3).astype(np.float32)
    tp_valid = np.array([2 * SPF, 1500], dtype=np.int32)
    tfm_in = rng.standard_normal((2, 10, TINY["hidden_size"])).astype(np.float32)
    return dict(audios24=audios24, pcm16=pcm16, warm=warm, full=full, valid=valid,
                tp_audio=tp_audio, tp_valid=tp_valid, tfm_in=tfm_in)


def refusal(fn):
    try:
        fn()
    except Exception as e:  # recorded for the test to check type and text
        return [type(e).__name__, str(e)]
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)

    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
    from tokenize_audio_tpu_torch.mimi.model import encode, transformer_apply
    from tokenize_audio_tpu_torch.parallel import multihost
    from tokenize_audio_tpu_torch.parallel.mesh import (
        batch_sharding, make_mesh, replicate_params, shard_params_tp,
    )

    dev = multihost.init_distributed(f"file://{args.store}", args.world, args.rank, device="cpu")
    world, rank = args.world, args.rank
    cfg = MimiConfig(**TINY)
    params = random_params(cfg, seed=0)
    x = inputs()
    saved, info = {}, {"refusals": {}}

    # every rank builds the same meshes in the same order
    dp_mesh = multihost.global_mesh(device=dev)
    span_mesh = make_mesh(dp=1, tp=world, device=dev)
    grid_mesh = make_mesh(dp=world // 2, tp=2, device=dev) if world >= 4 else None
    meshes = {"dp": dp_mesh, "span": span_mesh, **({"grid": grid_mesh} if grid_mesh else {})}
    info["meshes"] = {
        name: {"shape": m.shape, "data_index": m.data_index, "model_index": m.model_index,
               "world_size": m.world_size, "backend": m.backend,
               "model_group": torch.distributed.get_process_group_ranks(m.model_group),
               "data_group": torch.distributed.get_process_group_ranks(m.data_group)}
        for name, m in meshes.items()
    }

    # ---- tensor-parallel encode: this rank's slices and its data block --
    full_tfm = replicate_params(params, span_mesh)["tfm"]
    for name in [n for n in ("span", "grid") if n in meshes]:
        mesh = meshes[name]
        p_tp = shard_params_tp(params, mesh, cfg)
        for k in ("q", "k", "v", "o", "fc1", "fc2"):
            saved[f"tp_{name}_slice_{k}"] = p_tp["tfm"][0][k].numpy()
        rows = batch_sharding(mesh).span(len(x["tp_audio"]))
        codes, _ = encode(p_tp, cfg, torch.from_numpy(x["tp_audio"][rows]),
                          torch.from_numpy(x["tp_valid"][rows]), group=mesh.model_group)
        saved[f"tp_{name}_codes"] = codes.numpy()
        info[f"tp_{name}_rows"] = [rows.start, rows.stop]
        h = torch.from_numpy(x["tfm_in"])
        with torch.no_grad():
            got = transformer_apply(p_tp["tfm"], cfg, h, group=mesh.model_group)
            want = transformer_apply(full_tfm, cfg, h)
        info[f"tp_{name}_tfm_max_abs"] = float((got - want).abs().max())

    # ---- the engine over each mesh --------------------------------------
    def engine(mesh, **kw):
        return MimiEncoderEngine(params, cfg, EngineConfig(**{**ENGINE, **kw}), mesh=mesh)

    def keep(name, codes):
        for i, c in enumerate(codes):
            saved[f"{name}_{i}"] = c
        info[f"{name}_n"] = len(codes)

    eng = engine(dp_mesh)
    keep("engine24", eng.encode_batch(x["audios24"]))
    keep("engine16", eng.encode_batch(x["pcm16"], sr=16_000))
    keep("padded24", engine(dp_mesh, code_transfer_format="padded").encode_batch(x["audios24"]))
    warm = engine(dp_mesh, max_chunk_seconds=2.0)
    info["warmed"], info["buckets"] = warm.warmup(), len(warm.buckets)
    keep("warm", warm.encode_batch(x["warm"]))
    if grid_mesh is not None:
        keep("grid24", engine(grid_mesh).encode_batch(x["audios24"]))
    keep("span3", engine(span_mesh).encode_batch([x["full"][i, : x["valid"][i]] for i in range(3)]))
    # stream policy: each rank streams on its own replica, no collectives
    stream = engine(dp_mesh, max_chunk_seconds=2 * SPF / 24_000, long_audio_policy="stream")
    keep("stream", stream.encode_batch([x["full"][0]]))

    # ---- helpers path ---------------------------------------------------
    s, e = multihost.process_span(len(x["full"]))
    g = multihost.host_local_to_global(x["full"][s:e], dp_mesh)
    vg = multihost.host_local_to_global(x["valid"][s:e], dp_mesh)
    codes, _ = encode(replicate_params(params, dp_mesh), cfg, g, vg)
    saved["helpers"] = multihost.local_rows(codes)
    info["helpers_span"] = [s, e]

    # ---- refusals -------------------------------------------------------
    r = info["refusals"]
    r["batch_divisibility"] = refusal(lambda: engine(dp_mesh, batch_size=3))
    r["compact"] = refusal(lambda: engine(dp_mesh, code_transfer_format="compact"))
    r["not_a_mesh"] = refusal(
        lambda: MimiEncoderEngine(params, cfg, EngineConfig(**ENGINE), mesh=object()))
    r["autotune_transfer"] = refusal(lambda: eng.autotune_transfer(seconds=0.5, rounds=1))
    r["autotune_pipeline_depth"] = refusal(
        lambda: eng.autotune_pipeline_depth(seconds=0.5, rounds=1))
    r["autotune_drain_policy"] = refusal(lambda: eng.autotune_drain_policy(seconds=0.5, rounds=1))
    r["request_autotune"] = refusal(eng.request_autotune)
    r["oversized_mesh"] = refusal(lambda: make_mesh(dp=world + 1, device=dev))
    r["process_span"] = refusal(lambda: multihost.process_span(world + 1))

    np.savez(os.path.join(args.out, f"r{rank}.npz"), **saved)
    with open(os.path.join(args.out, f"r{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
