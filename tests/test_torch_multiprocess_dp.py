"""PyTorch port, the in-process mesh at 4 ranks (a real gloo world on the
CPU, ``torch_mesh_child.py``): dp 4, dp 2 x tp 2 and the tp-spanning
dp 1 x tp 4 — the mirror of tests/test_multiprocess_dp.py, held against the
JAX package's codes as test_torch_parallel.py holds the 2-rank world."""

import pytest

import torch_mesh_child as child
from torch_mesh_world import (
    check_engines,
    check_helpers,
    check_meshes,
    check_refusals,
    check_tp_encode,
    jax_references,
    start_world,
)

pytestmark = pytest.mark.slow  # a 4-process world, as the JAX mirror is

WORLD = 4


@pytest.fixture(scope="module")
def world_and_refs(tmp_path_factory):
    finish = start_world(WORLD, tmp_path_factory.mktemp(f"mesh{WORLD}"))
    refs = jax_references()
    return finish(), refs


def test_meshes_at_4(world_and_refs):
    """dp 4 x tp 1, dp 1 x tp 4 and the row-major 2 x 2 grid."""
    world = world_and_refs[0]
    check_meshes(world)
    assert "grid" in world.info[0]["meshes"]


def test_tp_encode_at_4(world_and_refs):
    """tp 4, and tp 2 within each of 2 data blocks."""
    check_tp_encode(*world_and_refs)


def test_engine_dp4_and_grid(world_and_refs):
    """dp 4 (24 kHz, fused 16 kHz, padded, warmed up) and dp 2 x tp 2."""
    world, refs = world_and_refs
    x = child.inputs()
    check_engines(world, refs, "engine24", refs["audios24"], x["audios24"])
    check_engines(world, refs, "engine16", refs["pcm16"], x["pcm16"], sr=16_000)
    check_engines(world, refs, "padded24", refs["audios24"], x["audios24"])
    check_engines(world, refs, "warm", refs["warm"], x["warm"])
    check_engines(world, refs, "grid24", refs["audios24"], x["audios24"])


def test_tp_spanning_engine_at_4(world_and_refs):
    """dp 1 x tp 4: dp below the process count, an odd 3-utterance list."""
    world, refs = world_and_refs
    x = child.inputs()
    check_engines(world, refs, "span3", refs["raw_rows"][:3],
                  [x["full"][i, : x["valid"][i]] for i in range(3)])


def test_helpers_path_at_4(world_and_refs):
    check_helpers(*world_and_refs)


def test_stream_policy_under_multiprocess(world_and_refs):
    """Every rank's streamed codes for the 4-frame row equal the JAX
    one-shot codes."""
    world, refs = world_and_refs
    for r in range(world.n):
        assert (world.codes(r, "stream")[0] == refs["raw"][0]).all()


def test_refusals_at_4(world_and_refs):
    check_refusals(world_and_refs[0])
