"""Parent-side helpers of the port's processor SIGKILL chaos mirrors
(tests/test_torch_{yodas2,corpus,runner,mls,emilia}_chaos.py): the tiny HF
oracle's weights as a checkpoint for the port's children, and their argv.
Imported by the parent tests only (it reaches the JAX package through
tests/mimi_fixtures.py); the children load the checkpoint with
``tokenize_audio_tpu_torch.mimi.weights.params_from_safetensors``."""

def oracle_checkpoint(path) -> str:
    """``make_oracle(tiny_hf_config())``'s state dict as ``path``
    (.safetensors): the weights each JAX chaos child builds for itself."""
    from safetensors.torch import save_file

    from tests.mimi_fixtures import make_oracle, tiny_hf_config

    model, _, _ = make_oracle(tiny_hf_config())
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(path))
    return str(path)


def port_argv(child_path: str, *args, params: str) -> list:
    """A port child's argv: its positionals, the checkpoint, on the CPU."""
    return [child_path, *map(str, args), "--params", params, "--device", "cpu"]
