"""PyTorch port, the in-process mesh: a real 2-rank gloo world on the CPU
(``torch_mesh_child.py``, rendezvous through a FileStore) held against the
JAX package on the tiny config — the tensor-parallel encode against the
replicated ``encode`` (tests/test_parallel.py), the dp-mesh, tp-spanning,
packed and warmed-up engines against the JAX solo engine
(tests/test_engine.py), the helpers path against one encode
(tests/test_multiprocess_dp.py), and the JAX refusals. The same checks at 4
ranks are in test_torch_multiprocess_dp.py (slow)."""

import numpy as np
import pytest
import torch

import torch_mesh_child as child
from torch_mesh_world import (
    assert_codes_match,
    check_engines,
    check_helpers,
    check_meshes,
    check_refusals,
    check_tp_encode,
    jax_references,
    start_world,
)
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig
from tokenize_audio_tpu_torch.parallel import multihost
from tokenize_audio_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_params_tp

WORLD = 2


@pytest.fixture(scope="module")
def world_and_refs(tmp_path_factory):
    """One world for the module; the JAX references are computed while
    its ranks run."""
    finish = start_world(WORLD, tmp_path_factory.mktemp(f"mesh{WORLD}"))
    refs = jax_references()
    return finish(), refs


def test_make_mesh_shapes(world_and_refs):
    """(dp, tp) = (2, 1) and (1, 2) over the world: indices and groups; and
    1 x 1 without a process group."""
    check_meshes(world_and_refs[0])
    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.world_size == 1
    assert (m.data_index, m.model_index, m.model_group, m.data_group) == (0, 0, None, None)
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(dp=2, device="cpu")


def test_tp_sharded_encode_equals_jax_replicated(world_and_refs):
    """shard_params_tp at dp 1, tp 2: each rank's Megatron slices, the
    transformer within 1e-5 of the replicated run, codes = JAX encode."""
    check_tp_encode(*world_and_refs)


def test_engine_dp_mesh_equals_jax_solo(world_and_refs):
    """dp 2: 24 kHz and fused 16 kHz int16; every rank returns the list."""
    world, refs = world_and_refs
    x = child.inputs()
    check_engines(world, refs, "engine24", refs["audios24"], x["audios24"])
    check_engines(world, refs, "engine16", refs["pcm16"], x["pcm16"], sr=16_000)


def test_packed_and_padded_under_mesh(world_and_refs):
    """Packed (the default) and padded transfer under the mesh give the
    JAX codes (compact is refused: test_mesh_refusals)."""
    world, refs = world_and_refs
    x = child.inputs()
    check_engines(world, refs, "engine24", refs["audios24"], x["audios24"])
    check_engines(world, refs, "padded24", refs["audios24"], x["audios24"])


def test_engine_warmup_under_mesh(world_and_refs):
    world, refs = world_and_refs
    for info in world.info:
        assert info["warmed"] == info["buckets"]
    check_engines(world, refs, "warm", refs["warm"], child.inputs()["warm"])


def test_tp_spanning_engine(world_and_refs):
    """dp 1, tp = world (dp < process count) on an odd 3-utterance list."""
    world, refs = world_and_refs
    x = child.inputs()
    check_engines(world, refs, "span3", refs["raw_rows"][:3],
                  [x["full"][i, : x["valid"][i]] for i in range(3)])


def test_helpers_path_equals_jax(world_and_refs):
    """process_span -> host_local_to_global -> encode -> local_rows,
    concatenated over ranks = one JAX encode of the batch."""
    check_helpers(*world_and_refs)


def test_stream_policy_under_mesh(world_and_refs):
    """Each rank streams on its own replica: the 4-frame row's codes equal
    its JAX one-shot codes."""
    world, refs = world_and_refs
    for r in range(world.n):
        np.testing.assert_array_equal(world.codes(r, "stream")[0], refs["raw"][0])


def test_mesh_refusals(world_and_refs):
    """batch_size % dp, compact, a non-mesh object, the four autotune
    calls under a multiprocess mesh, an oversized grid, an uneven span."""
    check_refusals(world_and_refs[0])


def test_multihost_helpers_single_process():
    """Without a process group the helpers are plain device puts and
    reads, and the span is the whole batch (tests/test_parallel.py:48-64)."""
    mesh = make_mesh(device="cpu")
    batch = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    g = multihost.host_local_to_global(batch, mesh)
    assert isinstance(g, torch.Tensor) and g.device == torch.device("cpu")
    assert (multihost.local_rows(g) == batch).all()
    assert multihost.process_span(16) == (0, 16)
    assert not torch.distributed.is_initialized()


def test_shard_params_tp_refuses_uneven_splits():
    from tokenize_audio_tpu_torch.mimi import random_params

    cfg = MimiConfig(**child.TINY)
    mesh = Mesh(dp=1, tp=3, data_index=0, model_index=0, device=torch.device("cpu"),
                world_size=3, backend="gloo")
    with pytest.raises(ValueError, match="num_attention_heads 4"):
        shard_params_tp(random_params(cfg, seed=0), mesh, cfg)
    # a tensor-parallel slice without its group is refused, not mis-run
    mesh2 = Mesh(dp=1, tp=2, data_index=0, model_index=1, device=torch.device("cpu"),
                 world_size=2, backend="gloo")
    p = shard_params_tp(random_params(cfg, seed=0), mesh2, cfg)
    from tokenize_audio_tpu_torch.mimi.model import transformer_apply

    with pytest.raises(ValueError, match="model group"):
        transformer_apply(p["tfm"], cfg, torch.zeros(1, 2, cfg.hidden_size))


def test_init_distributed_refuses_without_asking():
    """Partial coordinates are refused; without a card the default device
    raises (the CPU only when asked for); nothing is initialized."""
    with pytest.raises(ValueError, match="together"):
        multihost.init_distributed("localhost:1234")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.init_distributed("file:///nonexistent", 1, 0)
    assert not torch.distributed.is_initialized()


def test_engine_mesh_device_must_match():
    cfg = MimiConfig(**child.TINY)
    from tokenize_audio_tpu_torch.mimi import random_params

    with pytest.raises(ValueError, match="not the mesh's device"):
        MimiEncoderEngine(random_params(cfg, seed=0), cfg, EngineConfig(), mesh=make_mesh(device="cpu"),
                          device="cuda")


def test_a_flip_off_the_tie_class_fails(world_and_refs):
    """The near-tie rule itself: one frame whose code is moved away from
    the argmin is replayed on the port's RVQ input and refused."""
    _, refs = world_and_refs
    audios = child.inputs()["audios24"]
    want = [c.copy() for c in refs["audios24"]]
    got = [c.copy() for c in want]
    got[3][2, 1] = (got[3][2, 1] + 1) % child.TINY["codebook_size"]
    with pytest.raises(AssertionError, match="no near-tie"):
        assert_codes_match(got, want, audios, 24_000, refs["params"])
    got[4][0, 0] = (got[4][0, 0] + 1) % child.TINY["codebook_size"]
    with pytest.raises(AssertionError, match="2 flipped frames"):
        assert_codes_match(got, want, audios, 24_000, refs["params"])
