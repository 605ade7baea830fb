from tokenize_audio_tpu_torch.mimi.config import MimiConfig  # noqa: F401
from tokenize_audio_tpu_torch.mimi.model import encode  # noqa: F401
from tokenize_audio_tpu_torch.mimi.weights import (  # noqa: F401
    config_from_hf,
    convert_hf_state_dict,
    params_from_safetensors,
    params_from_torch_model,
    params_to_torch,
    random_params,
)
