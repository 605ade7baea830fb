"""Child process for the port's BPE-sampler SIGKILL chaos test
(test_torch_downstream_chaos): the port's CodeSampler over the seeded
3-shard x 60-sub-shard code-JSON hub of tests/sampler_chaos_child.py, with
its append-only fsync'd progress grain. Prints READY before sampling starts
and DONE <report> on completion. Run only by
tests/test_torch_downstream_chaos.py. Imports nothing of JAX or the JAX
package."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHARDS = {f"en{n:03d}": [f"{i:08d}" for i in range(60)] for n in range(3)}


def build_source(src):
    """Seeded code-JSON tree (the JAX child's, draw for draw); idempotent."""
    import numpy as np

    rng = np.random.default_rng(13)
    tmp = os.path.join(src.root, "tmp_build.json")
    for shard, subs in SHARDS.items():
        for sub in subs:
            entries = []
            for a in range(2):
                codes = {
                    f"c{c}": rng.integers(0, 2048, size=(12, int(rng.integers(8, 40)))).tolist()
                    for c in range(2)
                }
                entries.append({"audio_id": f"{shard}-{sub}-{a}", "codes": codes})
            with open(tmp, "w") as f:
                json.dump(entries, f)
            src.upload_file(tmp, f"data/{shard}/{sub}.json")
    os.unlink(tmp)


def main():
    srcdir, outdir = sys.argv[1:3]
    from tokenize_audio_tpu_torch.bpe.sampler import CodeSampler, pick_subshards
    from tokenize_audio_tpu_torch.hub import LocalHub

    src = LocalHub(srcdir)
    build_source(src)
    picks = pick_subshards(SHARDS, per_shard=40, seed=21)
    print("READY", flush=True)
    rep = CodeSampler(src, outdir, num_codebooks=8).sample(picks)
    print("DONE " + json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
